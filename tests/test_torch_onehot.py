"""PyTorch port, the row-wise (one-hot) histogram path against the JAX package.

``force_row_wise`` selects the one-hot histogram kernels in both packages,
and ``hist_variant`` their body.  On the CPU the port's one-hot entry points
take one plain version (the bf16 (hi, lo) pair summed per bin in float64 and
rounded once): every bf16-pair variant computes that function.  Here it is
held against the JAX Pallas kernels in interpret mode for each variant,
width and layout, and against the exact scatter-add.  The tolerance against
Pallas is ``|a-b|/(|b|+1)`` <= 1e-5, since both sum the same bf16 pair and
only the float32 summation order of the Pallas kernels differs; against the
scatter-add it is ``HIST_PARITY_TOL``, the pair's own error.

The Pallas kernels and the JAX trainer that reaches them run in clean
subprocesses (the conftest strips the backends Pallas registers its
lowerings with); the trainer sees ``jax.default_backend() == "tpu"`` while
its booster is built, so that ``force_row_wise`` picks the Pallas kernels,
which then run in interpret mode on the CPU.  The card's kernels:
``tests/test_torch_kernels_cuda.py``.
"""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops import onehot_variants as jov
from lightgbm_tpu_torch.device import NotPortedError
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import onehot_variants as tov
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_TOL = 1e-5

# every ported bf16-pair body at the widths of the JAX variant tests
CASES = [(v, B) for B in (64, 255) for v in tov.VARIANT_NAMES
         if tov.VARIANTS[v].kernel_id is not None
         and tov.VARIANTS[v].supports(B)]
LAYOUTS = ("featmajor", "rowmajor")
# the end-to-end runs: (variant, max_bin)
E2E = (("base", 63), ("packed", 63), ("staged", 255))


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


def _inputs(B):
    """Full-pass rows (f_limit < NC; f even, as the JAX row-major packed
    kernel needs) and leaf blocks: unsorted slots, slot 3 empty, a NaN
    gradient in block 4."""
    rng = np.random.default_rng(B)
    n, f = 1000, 6
    bins = rng.integers(0, B, (n, f + 2)).astype(np.uint8)
    g, h, m = _rows(rng, n)
    BR, k = 128, 5
    bl = np.array([2, 0, 4, 1, 2, 0], np.int32)
    comb = rng.integers(0, B, (bl.size * BR, f + 12)).astype(np.uint8)
    lg, lh, lm = _rows(rng, bl.size * BR)
    lg[4 * BR + 5] = np.nan
    return dict(bins=bins, g=g, h=h, m=m, f=f, comb=comb, lg=lg, lh=lh,
                lm=lm, bl=bl, k=k, BR=BR)


def _run_clean(code, args, timeout=600):
    env = {kk: v for kk, v in os.environ.items() if "PYTHONPATH" not in kk}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr


_PALLAS_SCRIPT = r"""
import json, sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from lightgbm_tpu.ops.histogram import _hist_pallas, _hist_leaves_pallas
cases = json.loads(sys.argv[1])
out = {}
for B in sorted({B for _, B in cases}):
    d = np.load(sys.argv[2] + f"/in{B}.npz")
    for v, b in cases:
        if b != B:
            continue
        for lay in ("featmajor", "rowmajor"):
            out[f"full_{v}_{B}_{lay}"] = np.asarray(_hist_pallas(
                d["bins"], d["g"], d["h"], d["m"], B, f_limit=int(d["f"]),
                layout=lay, variant=v, interpret=True))
        out[f"leaves_{v}_{B}"] = np.asarray(_hist_leaves_pallas(
            d["comb"], d["lg"], d["lh"], d["lm"], d["bl"], int(d["k"]), B,
            int(d["BR"]), int(d["f"]), variant=v, interpret=True))
np.savez(sys.argv[2] + "/out.npz", **out)
"""


@pytest.fixture(scope="module")
def pallas():
    """Every Pallas kernel output of CASES, from one clean subprocess."""
    with tempfile.TemporaryDirectory() as td:
        for B in (64, 255):
            np.savez(os.path.join(td, f"in{B}.npz"), **_inputs(B))
        _run_clean(_PALLAS_SCRIPT, [json.dumps(CASES), td])
        return dict(np.load(os.path.join(td, "out.npz")))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("variant,B", CASES)
def test_full_matches_pallas(pallas, variant, B, layout):
    d = _inputs(B)
    got = thist.build_histogram(*_t(d["bins"], d["g"], d["h"], d["m"]), B,
                                f_limit=d["f"], method="onehot",
                                variant=variant, layout=layout).numpy()
    ref = pallas[f"full_{variant}_{B}_{layout}"]
    assert got.shape == ref.shape == (d["f"], B, 3)
    assert relerr(got, ref) <= PALLAS_TOL
    exact = np.asarray(jhist._hist_scatter(d["bins"][:, :d["f"]], d["g"],
                                           d["h"], d["m"], B))
    assert relerr(got, exact) <= jhist.HIST_PARITY_TOL


@pytest.mark.parametrize("variant,B", CASES)
def test_leaves_match_pallas(pallas, variant, B):
    """The empty slot is zero and the NaN stays in its slot.  Inside that
    slot the Pallas kernel spreads the NaN over the gradient channel
    (0 * NaN in the one-hot product) where the plain version keeps it in
    its own bins; everything else agrees."""
    d = _inputs(B)
    got = thist.build_histogram_leaves(
        *_t(d["comb"], d["lg"], d["lh"], d["lm"], d["bl"]), d["k"], B,
        block_rows=d["BR"], f_limit=d["f"], method="onehot",
        variant=variant).numpy()
    ref = pallas[f"leaves_{variant}_{B}"]
    assert got.shape == ref.shape == (d["k"], d["f"], B, 3)
    assert np.all(got[3] == 0.0) and np.all(ref[3] == 0.0)
    nan_slot = int(d["bl"][4])
    fin = [s for s in range(d["k"]) if s != nan_slot]
    assert np.isfinite(got[fin]).all() and np.isfinite(ref[fin]).all()
    assert relerr(got[fin], ref[fin]) <= PALLAS_TOL
    assert relerr(got[nan_slot][..., 1:], ref[nan_slot][..., 1:]) <= PALLAS_TOL
    g_nan = np.isnan(got[nan_slot][..., 0])
    assert g_nan.any() and np.isnan(ref[nan_slot][..., 0][g_nan]).all()
    exact = np.asarray(jhist.build_histogram_leaves(
        d["comb"], d["lg"], d["lh"], d["lm"], d["bl"], d["k"], B,
        method="scatter", block_rows=d["BR"], f_limit=d["f"]))
    assert relerr(got[fin], exact[fin]) <= jhist.HIST_PARITY_TOL


@pytest.mark.parametrize("variant,B", [("base", 255), ("packed", 64),
                                       ("packed", 16)])
def test_finish_hist_matches_jax(variant, B):
    """The one inverse lane map, on a synthetic [k, 6, lanes] input."""
    f = 7
    Bp = tov.padded_bins(B)
    spec_t, spec_j = tov.VARIANTS[variant], jov.VARIANTS[variant]
    f_pad, lanes = tov.feat_geometry(spec_t, f, B, Bp)
    assert (f_pad, lanes) == jov.feat_geometry(spec_j, f, B, Bp)
    out = np.random.default_rng(B).normal(size=(3, 6, lanes)).astype(
        np.float32)
    got = tov.finish_hist(torch.as_tensor(out), f, B, Bp, spec_t).numpy()
    ref = np.asarray(jov.finish_hist(jnp.asarray(out), f, B, Bp, spec_j))
    np.testing.assert_array_equal(got, ref)


def test_registry_geometry_matches_jax():
    assert tov.VARIANT_NAMES == jov.VARIANT_NAMES
    assert tov.AUTO_CANDIDATES == jov.AUTO_CANDIDATES
    for B in (4, 16, 60, 63, 64, 128, 255, 256):
        assert tov.padded_bins(B) == jov.padded_bins(B)
        assert tov.pack_k(B) == jov.pack_k(B)
        for v in tov.VARIANT_NAMES:
            assert tov.VARIANTS[v].supports(B) == jov.VARIANTS[v].supports(B)
            if not tov.VARIANTS[v].supports(B):
                continue
            for f in (1, 7, 28):
                assert tov.total_lanes(v, f, B) == jov.total_lanes(v, f, B)


@pytest.mark.parametrize("jit", [False, True])
def test_split_bf16_pair_is_bit_identical_to_jax(jit):
    rng = np.random.default_rng(4)
    g, h, m = _rows(rng, 4096)
    g[:5] = [1e-30, -3e-7, 123456.789, 0.0, -0.0]
    fn = jax.jit(jhist._gh6) if jit else jhist._gh6
    ref = np.asarray(fn(g, h, m)).view(np.uint16)
    got = tov.split_bf16_pair(*_t(g, h, m))
    assert got.shape == (6, 4096) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), ref)
    assert bool((got[3:5] != 0).any())          # lo carries the residual


_E2E_SCRIPT = r"""
import json, sys, numpy as np, jax
from unittest import mock
jax.config.update("jax_platforms", "cpu")
import lightgbm_tpu as lgb
d = np.load(sys.argv[1])
out = {}
for v, mb in json.loads(sys.argv[2]):
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "max_bin": mb, "force_row_wise": True, "hist_variant": v}
    ds = lgb.Dataset(d["X"], label=d["y"], params=p)
    # force_row_wise picks the Pallas kernels only on a TPU backend; they
    # then run in interpret mode once the patch is gone
    with mock.patch.object(jax, "default_backend", return_value="tpu"):
        bst = lgb.Booster(params=p, train_set=ds)
    cfg = bst._gbdt._grower_cfg
    assert (cfg.hist_method, cfg.hist_variant) == ("pallas", v), cfg
    for _ in range(int(d["iters"])):
        bst.update()
    out[f"{v}_{mb}_model"] = np.array(bst.model_to_string())
    out[f"{v}_{mb}_pred"] = bst.predict(d["Xv"])
np.savez(sys.argv[3], **out)
"""
E2E_ITERS = 4


def _e2e_data():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(2500, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=2500)
         > 0).astype(np.float32)
    return X[:2000], y[:2000], X[2000:]


@pytest.fixture(scope="module")
def jax_e2e():
    X, y, Xv = _e2e_data()
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "in.npz"), os.path.join(td, "out.npz")
        np.savez(src, X=X, y=y, Xv=Xv, iters=E2E_ITERS)
        _run_clean(_E2E_SCRIPT, [src, json.dumps(E2E), dst])
        return dict(np.load(dst))


TREE_KEYS = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child")


def _trees(text):
    """model text -> (structure lines, leaf values) per tree."""
    out = []
    for block in text.split("Tree=")[1:]:
        kv = dict(line.split("=", 1) for line in block.splitlines()
                  if "=" in line)
        out.append(([kv[k] for k in TREE_KEYS if k in kv],
                    np.array(kv["leaf_value"].split(), float)))
    return out


@pytest.mark.parametrize("variant,max_bin", E2E)
def test_train_force_row_wise_matches_jax(jax_e2e, variant, max_bin):
    X, y, Xv = _e2e_data()
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "max_bin": max_bin, "force_row_wise": True, "hist_variant": variant}
    bt = lgt.train(p, lgt.Dataset(X, label=y), E2E_ITERS, verbose_eval=False,
                   device="cpu")
    cfg = bt._gbdt._grower_cfg
    assert (cfg.hist_method, cfg.hist_variant) == ("onehot", variant)
    tj = _trees(str(jax_e2e[f"{variant}_{max_bin}_model"]))
    tt = _trees(bt.model_to_string())
    assert len(tt) == len(tj) == E2E_ITERS
    for (sj, lj), (st, lt) in zip(tj, tt):
        assert st == sj
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv),
                               jax_e2e[f"{variant}_{max_bin}_pred"],
                               rtol=0, atol=5e-6)


def _cfg(**params):
    X, y, _ = _e2e_data()
    b = lgt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                   **params}, lgt.Dataset(X[:500], label=y[:500]), 1,
                  verbose_eval=False, device="cpu")
    return b._gbdt._grower_cfg


@pytest.mark.parametrize("variant", ["auto", "int8"])
def test_force_row_wise_refuses_unported_variants(variant):
    """The election (auto) and the int8 body are not ported: under
    force_row_wise they raise, never train through another path."""
    with pytest.raises(NotPortedError, match=f"hist_variant={variant}"):
        _cfg(force_row_wise=True, hist_variant=variant)
    with pytest.raises(NotPortedError, match="int8"):
        tov.resolve("int8", 64)
    with pytest.raises(ValueError, match="unknown"):
        tov.resolve("nope", 64)


@pytest.mark.parametrize("params", [{}, {"force_col_wise": True},
                                    {"force_col_wise": True,
                                     "hist_variant": "int8"}])
def test_col_wise_and_default_take_the_atomic_kernels(params):
    """As in the JAX package, hist_variant acts only under force_row_wise."""
    cfg = _cfg(**params)
    assert (cfg.hist_method, cfg.hist_variant) == ("atomic", "base")


def test_unsupported_width_resolves_to_base_with_a_warning():
    seen = []
    tlog.register_log_callback(seen.append)
    try:
        cfg = _cfg(force_row_wise=True, hist_variant="packed", max_bin=255,
                   verbose=0)                       # warnings on
        assert tov.resolve("packed", 64) == "packed"
    finally:
        tlog.register_log_callback(None)
        tlog.reset_log_level(tlog.LogLevel.INFO)
    assert (cfg.hist_method, cfg.hist_variant) == ("onehot", "base")
    assert any("hist_variant=packed does not support max_bin=256" in s
               for s in seen), seen
    with pytest.raises(ValueError, match="does not support"):
        thist.build_histogram(*_t(np.zeros((8, 2), np.uint8),
                                  *[np.zeros(8, np.float32)] * 3), 255,
                              method="onehot", variant="packed")
