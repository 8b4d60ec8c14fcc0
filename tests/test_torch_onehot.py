"""PyTorch port, the row-wise (one-hot) histogram path against the JAX package.

``force_row_wise`` selects the one-hot histogram kernels in both packages,
and ``hist_variant`` their body.  On the CPU the port's one-hot entry points
take the plain versions: the bf16 (hi, lo) pair summed per bin in float64
and rounded once, which every bf16-pair variant computes, and for ``int8``
the same three-level quantization per block of rows as the JAX package
(bit-identical), with exact integer sums folded by the block's scales in
float64.  Here they are held against the JAX Pallas kernels in interpret
mode for each variant, width and layout, and against the exact
scatter-add.  The tolerance against Pallas is ``|a-b|/(|b|+1)`` <= 1e-5,
since both sum the same values and only the float32 summation (and, for
int8, float32 folding) of the Pallas kernels differs; against the
scatter-add it is ``HIST_PARITY_TOL``, the variants' own error.  A
non-finite value makes its channel NaN in the one-hot product (``0·NaN``),
and the plain versions give the Pallas kernels' NaN positions exactly.

The Pallas kernels and the JAX trainer that reaches them run in clean
subprocesses (the conftest strips the backends Pallas registers its
lowerings with); the trainer sees ``jax.default_backend() == "tpu"`` while
its booster is built, so that ``force_row_wise`` picks the Pallas kernels,
which then run in interpret mode on the CPU.  Likewise the port's
trainer sees its own probe, ``models.gbdt.kernel_backend``, say ``cuda``,
so that ``force_row_wise`` picks the one-hot path, whose plain versions
then run on the CPU.  Unpatched, both packages follow their CPU dispatch
under ``force_row_wise`` (exact sums, ``hist_variant`` ignored), and they
are held to each other that way too.  The card's kernels:
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
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.ops import _build
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import onehot_variants as tov
from lightgbm_tpu_torch.utils import log as tlog

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_TOL = 1e-5

# every one-hot body at the widths of the JAX variant tests
CASES = [(v, B) for B in (64, 255) for v in tov.VARIANT_NAMES
         if tov.VARIANTS[v].kernel_id is not None
         and tov.VARIANTS[v].supports(B)]
LAYOUTS = ("featmajor", "rowmajor")
# the end-to-end runs: (variant, max_bin)
E2E = (("base", 63), ("packed", 63), ("staged", 255), ("int8", 63))


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
    slot the NaN covers the gradient channel (0 * NaN in the one-hot
    product), in the plain version exactly where the Pallas kernel puts
    it; everything else agrees."""
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
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[nan_slot][..., 0]).all()
    assert np.isfinite(got[nan_slot][..., 1:]).all()
    ok = np.isfinite(ref)
    assert relerr(got[ok], ref[ok]) <= PALLAS_TOL
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


@pytest.fixture
def card_dispatch(monkeypatch):
    """The port's trainer dispatches as on the card (one-hot kernels under
    force_row_wise), as JAX's sees a TPU in ``_E2E_SCRIPT``."""
    monkeypatch.setattr(tgbdt, "kernel_backend", lambda device: "cuda")


@pytest.mark.parametrize("variant,max_bin", E2E)
def test_train_force_row_wise_matches_jax(jax_e2e, card_dispatch, variant,
                                          max_bin):
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


@pytest.mark.parametrize("variant", [*tov.VARIANT_NAMES, "auto"])
def test_force_row_wise_refuses_unported_variants(variant, monkeypatch,
                                                  card_dispatch):
    """No hist_variant is refused under force_row_wise any more (the port
    once refused auto, the election, and int8): each trains through the
    one-hot path.  auto resolves to base on the CPU without timing
    anything; packed cannot serve max_bin=255 and falls back to base."""
    def no_timing(*a, **k):
        raise AssertionError("the election timed a candidate on the CPU")
    monkeypatch.setattr(tov, "_time_auto_candidate", no_timing)
    monkeypatch.setattr(tov, "_run_auto_bench", no_timing)
    cfg = _cfg(force_row_wise=True, hist_variant=variant)
    resolved = "base" if variant in ("auto", "packed") else variant
    assert (cfg.hist_method, cfg.hist_variant) == ("onehot", resolved)
    with pytest.raises(ValueError, match="unknown"):
        tov.resolve("nope", 64)


@pytest.mark.parametrize("variant,max_bin", [("auto", 255),
                                             ("staged", 255),
                                             ("packed", 63), ("int8", 63)])
def test_cpu_force_row_wise_matches_jax_cpu(variant, max_bin, monkeypatch):
    """Both packages on the CPU, neither backend probe patched: under
    force_row_wise the JAX package builds exact float32 histograms (its XLA
    one-hot root and scatter leaves) and ignores hist_variant, and so does
    the port (its plain atomic sums, exact in float64, rounded once),
    without an election.  Same trees; leaf values to 1e-5 and predictions
    to 5e-6, the summation-order tolerance of the default path
    (tests/test_torch_train.py)."""
    import lightgbm_tpu as lgb

    def no_timing(*a, **k):
        raise AssertionError("the election timed a candidate on the CPU")
    monkeypatch.setattr(tov, "_run_auto_bench", no_timing)
    X, y, Xv = _e2e_data()
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "max_bin": max_bin, "force_row_wise": True, "hist_variant": variant}
    assert jax.default_backend() == "cpu"
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), E2E_ITERS,
                   verbose_eval=False)
    assert (bj._gbdt._grower_cfg.hist_method,
            bj._gbdt._grower_cfg.hist_variant) == ("onehot", "base")
    bt = lgt.train(p, lgt.Dataset(X, label=y), E2E_ITERS, verbose_eval=False,
                   device="cpu")
    cfg = bt._gbdt._grower_cfg
    assert (cfg.hist_method, cfg.hist_variant) == ("atomic", "base")
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert len(tt) == len(tj) == E2E_ITERS
    for (sj, lj), (st, lt) in zip(tj, tt):
        assert st == sj
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)


@pytest.mark.parametrize("params", [{}, {"force_col_wise": True},
                                    {"force_col_wise": True,
                                     "hist_variant": "int8"}])
def test_col_wise_and_default_take_the_atomic_kernels(params):
    """As in the JAX package, hist_variant acts only under force_row_wise."""
    cfg = _cfg(**params)
    assert (cfg.hist_method, cfg.hist_variant) == ("atomic", "base")


def test_unsupported_width_resolves_to_base_with_a_warning(card_dispatch):
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


# --------------------------------------------------------------------------
# int8: the quantizer and its blocks
# --------------------------------------------------------------------------

def _jax_level_chain(x):
    """The JAX package's ``level`` chain (``_contrib_int8``) on one block
    ``x [3, BR]``, jitted as the Pallas kernel runs it."""
    def level(x):
        s = jnp.maximum(jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0,
                        jnp.float32(1e-30))
        q = jnp.round(x / s)
        return s, q, x - q * s

    s1, q1, r1 = level(x)
    s2, q2, r2 = level(r1)
    s3, q3, _ = level(r2)
    q = jnp.concatenate([q1, q2, q3], axis=0).astype(jnp.int8)
    return q, jnp.concatenate([s1, s2, s3], axis=0)[:, 0]


def _quant_rows(br, nb):
    """Heavy-tailed rows over ``nb`` blocks: block 1 all zero, block 2 at
    exact .5 ties (max 127 gives s = 1), block 3 with a NaN gradient and
    block 4 with an infinite hessian; a ragged last block."""
    rng = np.random.default_rng(21)
    n = nb * br - 37
    x = (rng.normal(size=(3, n)) * rng.lognormal(0, 3, (3, n))).astype(
        np.float32)
    x[:, br:2 * br] = 0.0
    x[:, 2 * br:3 * br] = rng.integers(-120, 120, (3, br)) + 0.5
    x[:, 2 * br] = 127.0
    x[0, 3 * br + 9] = np.nan
    x[1, 4 * br + 3] = np.inf
    return x


def _hold_jax_chain(q, s, x, br):
    """``(q, s)`` bit-identical to the JAX ``level`` chain on each block of
    ``x [3, N]`` (the last one padded with zeros): q equal, NaN scales in
    the same places, every other scale with the same bits."""
    nb = -(-x.shape[1] // br)
    assert q.shape == (9, x.shape[1]) and q.dtype == torch.int8
    assert s.shape == (nb, 9) and s.dtype == torch.float32
    xp = np.zeros((3, nb * br), np.float32)
    xp[:, :x.shape[1]] = x
    chain = jax.jit(_jax_level_chain)
    for b in range(nb):
        qj, sj = (np.asarray(a) for a in chain(xp[:, b * br:(b + 1) * br]))
        qt = q[:, b * br:(b + 1) * br].numpy()
        np.testing.assert_array_equal(qt, qj[:, :qt.shape[1]])
        st = s[b].numpy()
        np.testing.assert_array_equal(np.isnan(st), np.isnan(sj))
        ok = ~np.isnan(sj)
        np.testing.assert_array_equal(st[ok].view(np.int32),
                                      sj[ok].view(np.int32))


@pytest.mark.parametrize("br", [128, 512])
def test_quantize_int8_blocks_is_bit_identical_to_jax(br):
    x = _quant_rows(br, 6)
    q, s = tov.quantize_int8_blocks_plain(torch.as_tensor(x), br)
    _hold_jax_chain(q, s, x, br)
    assert (s[1] == np.float32(1e-30)).all() and (q[:, br:2 * br] == 0).all()
    assert (s[2, 0:3] == 1.0).all()                     # the tie block
    ties = q[0:3, 2 * br + 1:3 * br].numpy()
    np.testing.assert_array_equal(ties, np.round(x[:, 2 * br + 1:3 * br]))
    assert np.isnan(s[3, [0, 3, 6]].numpy()).all()      # the NaN channel
    assert bool(torch.isinf(s[4, 1]))
    assert bool(torch.isnan(s[4, [4, 7]]).all())
    assert tov.RECIP_127 == float(np.float32(1) / np.float32(127))


@pytest.mark.parametrize("br", [128, 512])
def test_quantize_int8_fused_entry_is_bit_identical_to_jax(br):
    """The fused pre-pass (``quantize_int8``) on grad, hess and mask, by its
    plain route on CPU tensors, against the JAX chain on ``jnp.stack([g*m,
    h*m, m])``: block 1 all zero, a NaN gradient under a zero mask in block
    3 (NaN·0 is NaN), an infinite hessian in block 4, a ragged last
    block."""
    rng = np.random.default_rng(22)
    nb = 6
    n = nb * br - 37
    g, h, m = _rows(rng, n)
    m[br:2 * br] = 0.0
    g[3 * br + 9], m[3 * br + 9] = np.nan, 0.0
    h[4 * br + 3], m[4 * br + 3] = np.inf, 1.0
    before = dict(thist.launch_counts)
    q, s = thist.quantize_int8(*map(torch.as_tensor, (g, h, m)), br)
    gj, hj, mj = map(jnp.asarray, (g, h, m))
    _hold_jax_chain(q, s, np.asarray(jnp.stack([gj * mj, hj * mj, mj])), br)
    assert (s[1] == np.float32(1e-30)).all() and (q[:, br:2 * br] == 0).all()
    assert np.isnan(s[3, [0, 3, 6]].numpy()).all()
    assert bool(torch.isfinite(s[3, [1, 2, 4, 5, 7, 8]]).all())
    assert bool(torch.isinf(s[4, 1])) and bool(torch.isnan(s[4, [4, 7]]).all())
    assert thist.launch_counts == before


@pytest.mark.parametrize("n,f,B", [(1000, 6, 64), (5000, 28, 255),
                                   (300, 28, 255), (20_000, 300, 64),
                                   (5000, 28, 1024), (250_000, 35, 2599)])
def test_pallas_block_rows_match_jax_arithmetic(n, f, B):
    """The quantization blocks are the Pallas kernels' BR, recomputed here
    from the JAX package's own constants (``_hist_pallas``)."""
    assert (tov.PALLAS_BLOCK_ROWS, tov.PALLAS_BLOCK_LANES,
            tov.PALLAS_ONEHOT_BYTES) == (jhist._PALLAS_BLOCK_ROWS,
                                         jhist._PALLAS_BLOCK_LANES,
                                         jhist._PALLAS_ONEHOT_BYTES)
    for v in ("int8", "base", "packed"):
        spec = jov.VARIANTS[v]
        if not spec.supports(B):
            continue
        Bp = jov.padded_bins(B)
        gf = spec.group_feats(B, Bp)
        lpf = spec.group_lanes(B, Bp) // gf
        align = max(8, gf)
        fc = max(align, (jhist._PALLAS_BLOCK_LANES // lpf) // align * align)
        for layout, lanes in (("featmajor", fc * lpf), ("rowmajor", f * lpf)):
            cap = max(128, (jhist._PALLAS_ONEHOT_BYTES // (2 * lanes))
                      // 128 * 128)
            want = max(128, min(jhist._PALLAS_BLOCK_ROWS, cap,
                                -(-n // 128) * 128))
            assert tov.pallas_block_rows(v, layout, n, f, B) == want
    assert tov.pallas_block_rows("int8", "featmajor", 1_000_000, 28,
                                 256) == 1024
    assert tov.pallas_block_rows("int8", "featmajor", 1_000_000, 28,
                                 64) == 1024
    assert tov.pallas_block_rows("int8", "rowmajor", 1_000_000, 28,
                                 256) == 512
    # u16 widths: BR is capped by the 8 MiB one-hot tile
    assert tov.pallas_block_rows("int8", "featmajor", 1_000_000, 28,
                                 1024) == 512
    assert tov.pallas_block_rows("int8", "featmajor", 250_000, 35,
                                 2599) == 128


_BLOCKS_SCRIPT = r"""
import sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from lightgbm_tpu.ops.histogram import _hist_pallas
d = np.load(sys.argv[1])
out = {lay: np.asarray(_hist_pallas(d["bins"], d["g"], d["h"], d["m"], 255,
                                    layout=lay, variant="int8",
                                    interpret=True))
       for lay in ("featmajor", "rowmajor")}
np.savez(sys.argv[2], **out)
"""


def test_int8_blocks_decide_the_result_as_in_pallas():
    """At f=28, B=255 the featmajor kernel quantizes per 1024 rows and the
    rowmajor one per 512, and with heavy-tailed gradients the two differ
    by far more than PALLAS_TOL: the port matches each layout's Pallas
    result only with that layout's blocks."""
    rng = np.random.default_rng(5)
    n, f = 2048, 28
    bins = rng.integers(0, 255, (n, f)).astype(np.uint8)
    g = (rng.normal(size=n) * rng.lognormal(0, 3, n)).astype(np.float32)
    g[100] = 3e4                               # one outlier in block 0
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    m = np.ones(n, np.float32)
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "in.npz"), os.path.join(td, "out.npz")
        np.savez(src, bins=bins, g=g, h=h, m=m)
        _run_clean(_BLOCKS_SCRIPT, [src, dst])
        ref = dict(np.load(dst))
    got = {lay: thist.build_histogram(*_t(bins, g, h, m), 255,
                                      method="onehot", variant="int8",
                                      layout=lay).numpy()
           for lay in LAYOUTS}
    assert relerr(got["featmajor"], ref["featmajor"]) <= PALLAS_TOL
    assert relerr(got["rowmajor"], ref["rowmajor"]) <= PALLAS_TOL
    assert relerr(got["featmajor"], ref["rowmajor"]) > 10 * PALLAS_TOL


# --------------------------------------------------------------------------
# K4: the shootout shell
# --------------------------------------------------------------------------

BENCH_CASES = [(v, B) for B in (64, 255)
               for v in ("base", "packed", "staged", "int8")
               if tov.VARIANTS[v].supports(B)]

_BENCH_SCRIPT = r"""
import json, sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from lightgbm_tpu.ops import onehot_variants as ov
out = {}
for v, B in json.loads(sys.argv[1]):
    d = np.load(sys.argv[2] + f"/in{B}.npz")
    prep, run = ov.make_bench_kernel(v, int(d["f"]), B, 128, interpret=True)
    out[f"{v}_{B}"] = np.asarray(run(d["bins_t"],
                                     prep(d["g"], d["h"], d["m"])))
np.savez(sys.argv[2] + "/out.npz", **out)
"""


def _bench_inputs(B):
    rng = np.random.default_rng(30 + B)
    n, f = 1024, 9
    bins = rng.integers(0, B, (n, f)).astype(np.uint8)
    g, h, m = _rows(rng, n)
    return dict(bins_t=np.ascontiguousarray(bins.T), g=g, h=h, m=m, f=f)


@pytest.fixture(scope="module")
def jax_bench():
    with tempfile.TemporaryDirectory() as td:
        for B in (64, 255):
            np.savez(os.path.join(td, f"in{B}.npz"), **_bench_inputs(B))
        _run_clean(_BENCH_SCRIPT, [json.dumps(BENCH_CASES), td])
        return dict(np.load(os.path.join(td, "out.npz")))


@pytest.mark.parametrize("variant,B", BENCH_CASES)
def test_bench_kernel_matches_jax(jax_bench, variant, B):
    d = _bench_inputs(B)
    prep, run = tov.make_bench_kernel(variant, d["f"], B, 128)
    rows = prep(*_t(d["g"], d["h"], d["m"]))
    got = run(torch.as_tensor(d["bins_t"]), rows).numpy()
    ref = jax_bench[f"{variant}_{B}"]
    assert got.shape == ref.shape == (d["f"], B, 3)
    assert relerr(got, ref) <= PALLAS_TOL
    exact = np.asarray(jhist._hist_scatter(d["bins_t"].T, d["g"], d["h"],
                                           d["m"], B))
    assert relerr(got, exact) <= jhist.HIST_PARITY_TOL
    with pytest.raises(ValueError, match="multiple of block_rows"):
        run(torch.as_tensor(d["bins_t"][:, :1000]), rows[:, :1000])


# --------------------------------------------------------------------------
# the election (hist_variant=auto)
# --------------------------------------------------------------------------

def test_parity_tolerance_is_jax():
    assert thist.HIST_PARITY_TOL == jhist.HIST_PARITY_TOL


def test_pick_variant_caches_one_bench_per_key(monkeypatch):
    """One election per (card, width): later fits reuse the winner; on the
    CPU 'base' comes back with nothing timed."""
    calls = []

    def fake_bench(max_bin, f, dev):
        calls.append((max_bin, dev.type))
        return "staged"

    monkeypatch.setattr(tov, "_run_auto_bench", fake_bench)
    monkeypatch.setattr(tov, "_AUTO_CACHE", {})
    assert tov.pick_variant(256, 28, device="cpu") == "base"
    assert calls == []
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert tov.pick_variant(64, 28, device="cuda") == "staged"
    assert tov.pick_variant(64, 28, device="cuda") == "staged"
    assert tov.pick_variant(64, 99, device="cuda") == "staged"  # same key
    assert calls == [(64, "cuda")]
    assert tov.pick_variant(256, 28, device="cuda") == "staged"
    assert calls == [(64, "cuda"), (256, "cuda")]


def _small_bench_data(monkeypatch):
    orig = tov._auto_bench_data
    monkeypatch.setattr(tov, "_auto_bench_data",
                        lambda mb, f, dev: orig(mb, f, dev, rows=2048))


@pytest.mark.parametrize("max_bin", [64, 256])
def test_election_skips_unsupported_widths(monkeypatch, max_bin):
    _small_bench_data(monkeypatch)
    timed = []

    def fake_time(name, bins, g, h, m, mb, ref, iters=5):
        assert bins.shape == (2048, 28) and ref.shape == (28, mb, 3)
        timed.append(name)
        return {"base": 3.0, "u8cmp": 2.0, "staged": 4.0, "packed": 1.0,
                "int8": 5.0}[name] * 1e-3, 1e-6

    monkeypatch.setattr(tov, "_time_auto_candidate", fake_time)
    won = tov._run_auto_bench(max_bin, 28, torch.device("cpu"))
    want = [v for v in tov.AUTO_CANDIDATES if v != "packed" or max_bin == 64]
    assert timed == want
    assert won == ("packed" if max_bin == 64 else "u8cmp")


def test_election_disqualifies_a_faster_candidate_that_fails_parity(
        monkeypatch):
    _small_bench_data(monkeypatch)

    def fake_time(name, *a, **k):
        if name == "int8":
            return 0.5e-3, 10 * thist.HIST_PARITY_TOL     # fastest, wrong
        return {"base": 3.0, "u8cmp": 2.0, "staged": 4.0}[name] * 1e-3, 0.0

    monkeypatch.setattr(tov, "_time_auto_candidate", fake_time)
    assert tov._run_auto_bench(256, 28, torch.device("cpu")) == "u8cmp"
    res = tov.AUTO_RESULTS[("cpu", 256)]
    assert not res["int8"]["qualified"] and res["u8cmp"]["qualified"]
    assert res["int8"]["relerr"] > thist.HIST_PARITY_TOL


def test_election_raises_on_a_build_or_launch_error(monkeypatch):
    """Unlike the JAX package, which skips a candidate that fails to lower,
    the port raises: a kernel that does not build is a fault of the port."""
    _small_bench_data(monkeypatch)

    def fake_time(name, *a, **k):
        if name == "staged":
            raise _build.KernelBuildError("staged: nvcc exit 1")
        return 1e-3, 0.0

    monkeypatch.setattr(tov, "_time_auto_candidate", fake_time)
    with pytest.raises(_build.KernelBuildError, match="staged"):
        tov._run_auto_bench(256, 28, torch.device("cpu"))
    monkeypatch.undo()
    _small_bench_data(monkeypatch)
    # the real timer on CPU tensors: the kernel wrapper refuses to launch
    with pytest.raises(ValueError, match="CUDA"):
        tov._run_auto_bench(256, 28, torch.device("cpu"))
