"""PyTorch port, the one-hot histogram path at u16 widths against the JAX
package.

Above 256 bins (``max_bin > 255``, or an EFB bundle wider than 256) the bin
matrix is ``uint16`` and four one-hot bodies serve the width: ``base``,
``i16cmp``, ``staged`` and ``int8`` (``VariantSpec.supports``).  On the CPU
the port's one-hot entry points take their plain versions, which widen the
bins first (``widen_bins``); here they are held against the JAX Pallas
kernels in interpret mode, featmajor, rowmajor and per leaf, at B = 300
(Bp = 384, not a power of two), 1,024 and 2,599 (the sparse_efb bundle
width, Bp = 2,688), with bins >= B present, within ``PALLAS_TOL``, and
against the exact scatter within ``HIST_PARITY_TOL``.

The per-leaf entry takes the one-hot kernel only inside the JAX package's
cut for its Pallas leaves kernel (``f * Bp <= 32,768`` lanes, a ``[k, 6, f
* Bp]`` float32 accumulator of at most 48 MB) and the atomic method
outside it, as the JAX package takes its scatter there.

End to end, with the port dispatching as on the card (``card_dispatch``)
and the JAX trainer seeing a TPU (Pallas in interpret mode), ``staged``
and ``int8`` at ``max_bin=1023`` and ``base`` at 33 features (outside the
leaves cut) grow the JAX package's trees.  The variants are named: ``auto``
cannot run at u16 in the JAX package, whose election draws ``uint8`` bins
(numpy refuses ``high=1023`` for that type); the port's draws ``uint16``.
"""
import json
import os
import tempfile

import jax  # noqa: F401  (JAX on the CPU before the port's imports)
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops import onehot_variants as jov
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import onehot_variants as tov
from test_torch_onehot import (PALLAS_TOL, _rows, _run_clean, _t, _trees,
                               card_dispatch, relerr)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

WIDTHS = (300, 1024, 2599)
U16_BODIES = ("base", "i16cmp", "staged", "int8")
CASES = [(v, B) for B in WIDTHS for v in U16_BODIES]
LAYOUTS = ("featmajor", "rowmajor")


def _u16(rng, shape, hi):
    """u16 bins in [0, hi), hi a little above B: bins >= B are dropped."""
    return rng.integers(0, hi, shape).astype(np.uint16)


def _scatter_exact(bins, g, h, m, B):
    """The JAX package's exact scatter with bins >= B dropped, as the
    one-hot kernels drop them (``_hist_scatter`` clips them into bin B - 1):
    they go to an extra bin B, which is cut off."""
    b = np.where(bins < B, bins, B).astype(np.int32)
    return np.asarray(jhist._hist_scatter(b, g, h, m, B + 1))[:, :B]


def _inputs(B):
    """Full-pass rows (f_limit < NC) and leaf blocks: unsorted slots, slot
    3 empty, a NaN gradient in block 4."""
    rng = np.random.default_rng(B)
    n, f = 1000, 4
    bins = _u16(rng, (n, f + 2), B + 40)
    g, h, m = _rows(rng, n)
    BR, k = 128, 5
    bl = np.array([2, 0, 4, 1, 2, 0], np.int32)
    comb = _u16(rng, (bl.size * BR, f + 6), B + 40)
    lg, lh, lm = _rows(rng, bl.size * BR)
    lg[4 * BR + 5] = np.nan
    return dict(bins=bins, g=g, h=h, m=m, f=f, comb=comb, lg=lg, lh=lh,
                lm=lm, bl=bl, k=k, BR=BR)


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
        for B in WIDTHS:
            np.savez(os.path.join(td, f"in{B}.npz"), **_inputs(B))
        _run_clean(_PALLAS_SCRIPT, [json.dumps(CASES), td])
        return dict(np.load(os.path.join(td, "out.npz")))


def test_u16_bodies_are_the_jax_packages():
    """The bodies that serve a width above 256 are the JAX registry's, and
    the others resolve to base with a warning, as there."""
    for B in WIDTHS:
        served = [v for v in tov.VARIANT_NAMES if tov.VARIANTS[v].supports(B)]
        assert served == [v for v in jov.VARIANT_NAMES
                          if jov.VARIANTS[v].supports(B)]
        assert tuple(served) == U16_BODIES
        for v in tov.VARIANT_NAMES:
            assert tov.resolve(v, B) == (v if v in served else "base")
        for f in (1, 4, 28, 35):
            for v in served:
                assert tov.total_lanes(v, f, B) == jov.total_lanes(v, f, B)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("variant,B", CASES)
def test_full_u16_matches_pallas(pallas, variant, B, layout):
    d = _inputs(B)
    bins = torch.as_tensor(d["bins"])
    assert bins.dtype == torch.uint16
    got = thist.build_histogram(bins, *_t(d["g"], d["h"], d["m"]), B,
                                f_limit=d["f"], method="onehot",
                                variant=variant, layout=layout).numpy()
    ref = pallas[f"full_{variant}_{B}_{layout}"]
    assert got.shape == ref.shape == (d["f"], B, 3)
    assert relerr(got, ref) <= PALLAS_TOL
    exact = _scatter_exact(d["bins"][:, :d["f"]], d["g"], d["h"], d["m"], B)
    assert relerr(got, exact) <= jhist.HIST_PARITY_TOL


# int8 over quantization blocks under 512 rows, which the card's bucketed
# design spans with its 512-row segments: (layout, B, f, rows, block rows)
# -- row-major at B = 1,024 over 17 features, the fewest whose lanes make
# the JAX package's blocks 128 rows (as at 1M x 28), and feature-major at
# B = 1,536 (256-row blocks); feature-major at B = 2,599 (128-row blocks)
# is a case of the test above
SMALL_BLOCKS = [("rowmajor", 1024, 17, 300, 128),
                ("featmajor", 1536, 4, 600, 256)]

_SMALL_BLOCKS_SCRIPT = r"""
import json, sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from lightgbm_tpu.ops.histogram import _hist_pallas
out = {}
for lay, B, f, n, br in json.loads(sys.argv[1]):
    d = np.load(sys.argv[2] + f"/in_{lay}_{B}.npz")
    out[f"{lay}_{B}"] = np.asarray(_hist_pallas(
        d["bins"], d["g"], d["h"], d["m"], B, f_limit=f, layout=lay,
        variant="int8", interpret=True))
np.savez(sys.argv[2] + "/out.npz", **out)
"""


def _small_block_inputs(B, f, n, br):
    """A few hundred rows (a ragged last block), bins >= B present, and a
    NaN gradient in the third block."""
    rng = np.random.default_rng(B + f)
    bins = _u16(rng, (n, f + 2), B + 40)
    g, h, m = _rows(rng, n)
    g[2 * br + 7] = np.nan
    return dict(bins=bins, g=g, h=h, m=m)


@pytest.fixture(scope="module")
def pallas_small_blocks():
    with tempfile.TemporaryDirectory() as td:
        for lay, B, f, n, br in SMALL_BLOCKS:
            np.savez(os.path.join(td, f"in_{lay}_{B}.npz"),
                     **_small_block_inputs(B, f, n, br))
        _run_clean(_SMALL_BLOCKS_SCRIPT, [json.dumps(SMALL_BLOCKS), td])
        return dict(np.load(os.path.join(td, "out.npz")))


@pytest.mark.parametrize("layout,B,f,n,br", SMALL_BLOCKS)
def test_int8_small_blocks_match_pallas(pallas_small_blocks, layout, B, f,
                                        n, br):
    """``build_histogram(..., method="onehot", hist_variant="int8")`` over
    quantization blocks of fewer than 512 rows (the JAX package's own
    ``pallas_block_rows`` at these shapes) against ``_hist_pallas`` int8 in
    interpret mode: the NaN block's scale makes channel 0 NaN on every
    lane in both, and the rest agrees within ``PALLAS_TOL`` and with the
    exact scatter within ``HIST_PARITY_TOL``."""
    d = _small_block_inputs(B, f, n, br)
    assert tov.pallas_block_rows("int8", layout, n, f, B) == br
    got = thist.build_histogram(torch.as_tensor(d["bins"]),
                                *_t(d["g"], d["h"], d["m"]), B, f_limit=f,
                                method="onehot", variant="int8",
                                layout=layout).numpy()
    ref = pallas_small_blocks[f"{layout}_{B}"]
    assert got.shape == ref.shape == (f, B, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[..., 0]).all() and np.isfinite(got[..., 1:]).all()
    assert relerr(got[..., 1:], ref[..., 1:]) <= PALLAS_TOL
    exact = _scatter_exact(d["bins"][:, :f], d["g"], d["h"], d["m"], B)
    assert relerr(got[..., 1:], exact[..., 1:]) <= jhist.HIST_PARITY_TOL


@pytest.mark.parametrize("variant,B", CASES)
def test_leaves_u16_match_pallas(pallas, variant, B):
    """Inside the leaves cut at every width here: the one-hot plain
    version, the empty slot zero and the NaN confined to its slot's
    gradient channel, exactly where the Pallas kernel puts it."""
    d = _inputs(B)
    assert thist.onehot_leaves_fits(d["f"], d["k"], B)
    got = thist.build_histogram_leaves(
        torch.as_tensor(d["comb"]), *_t(d["lg"], d["lh"], d["lm"], d["bl"]),
        d["k"], B, block_rows=d["BR"], f_limit=d["f"], method="onehot",
        variant=variant).numpy()
    ref = pallas[f"leaves_{variant}_{B}"]
    assert got.shape == ref.shape == (d["k"], d["f"], B, 3)
    assert np.all(got[3] == 0.0) and np.all(ref[3] == 0.0)
    nan_slot = int(d["bl"][4])
    fin = [s for s in range(d["k"]) if s != nan_slot]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[nan_slot][..., 0]).all()
    assert np.isfinite(got[fin]).all()
    ok = np.isfinite(ref)
    assert relerr(got[ok], ref[ok]) <= PALLAS_TOL
    comb = np.where(d["comb"] < B, d["comb"], B).astype(np.int32)
    exact = np.asarray(jhist.build_histogram_leaves(
        comb, d["lg"], d["lh"], d["lm"], d["bl"], d["k"], B + 1,
        method="scatter", block_rows=d["BR"], f_limit=d["f"]))[..., :B, :]
    assert relerr(got[fin], exact[fin]) <= jhist.HIST_PARITY_TOL


@pytest.mark.parametrize("B", WIDTHS)
def test_bench_shell_u16_matches_scatter(B):
    """K4 on u16 bins as the caller transposed them: the plain version of
    each body the election times at u16, against the exact scatter."""
    rng = np.random.default_rng(40 + B)
    n, f, BR = 1024, 5, 128
    bins = _u16(rng, (n, f), B)
    g, h, m = _rows(rng, n)
    exact = _scatter_exact(bins, g, h, m, B)
    for v in ("base", "staged", "int8"):
        prep, run = tov.make_bench_kernel(v, f, B, BR)
        got = run(torch.as_tensor(np.ascontiguousarray(bins.T)),
                  prep(*_t(g, h, m))).numpy()
        assert got.shape == (f, B, 3)
        assert relerr(got, exact) <= jhist.HIST_PARITY_TOL


# --------------------------------------------------------------------------
# the leaves cut (the JAX package's, for its Pallas leaves kernel)
# --------------------------------------------------------------------------

def test_leaves_cut_is_the_jax_packages():
    assert thist.ONEHOT_LEAVES_MAX_LANES == jhist._PALLAS_ROWMAJOR_MAX_LANES
    assert thist.ONEHOT_LEAVES_ACC_BYTES == jhist._PALLAS_LEAFACC_BYTES
    for f, k, B in ((28, 16, 255), (128, 16, 255), (129, 16, 255),
                    (137, 16, 255), (28, 16, 1024), (32, 16, 1024),
                    (33, 16, 1024), (35, 16, 2599), (12, 16, 2599),
                    (8, 64, 4096), (8, 16, 4096), (4, 512, 64),
                    (2, 1024, 255)):
        lanes = f * jov.padded_bins(B)
        want = (lanes <= jhist._PALLAS_ROWMAJOR_MAX_LANES
                and k * 6 * lanes * 4 <= jhist._PALLAS_LEAFACC_BYTES)
        assert thist.onehot_leaves_fits(f, k, B) == want, (f, k, B)
    # the shapes this port trains at
    assert thist.onehot_leaves_fits(28, 16, 1024)        # wide_bins
    assert not thist.onehot_leaves_fits(35, 16, 2599)    # sparse_efb
    assert not thist.onehot_leaves_fits(137, 16, 255)    # MS LTR width


@pytest.mark.parametrize("f,B", [(137, 255), (33, 1024)])
def test_leaves_outside_the_cut_take_the_atomic_method(f, B):
    """Outside the cut the one-hot method's per-leaf histograms are the
    atomic method's, exact sums rounded once, on the CPU (on the card the
    atomic kernel), not the bf16 pair's."""
    rng = np.random.default_rng(f)
    k, BR = 4, 128
    bl = np.array([1, 0, 3, 2, 1], np.int32)
    C = bl.size * BR
    dt = np.uint8 if B <= 256 else np.uint16
    comb = rng.integers(0, B, (C, f + 3)).astype(dt)
    g, h, m = _rows(rng, C)
    args = (torch.as_tensor(comb), *_t(g, h, m, bl), k, B)
    kw = dict(block_rows=BR, f_limit=f)
    assert not thist.onehot_leaves_fits(f, k, B)
    for v in ("base", "staged", "int8"):
        got = thist.build_histogram_leaves(*args, method="onehot", variant=v,
                                           **kw)
        assert torch.equal(got, thist.hist_leaves_plain(*args, **kw))
    pair = thist.hist_onehot_leaves_plain(*args, **kw)
    assert not torch.equal(got, pair)


# --------------------------------------------------------------------------
# the election's data at u16
# --------------------------------------------------------------------------

def test_election_draws_u16_bins_above_256():
    """The port draws uint16 bins over the whole width above 256 bins
    (uint8 up to 256, as the JAX package); the JAX package's draw raises
    there (its fault, kept as it is)."""
    bins, g, h, m = tov._auto_bench_data(1023, 28, torch.device("cpu"),
                                         rows=4096)
    assert bins.dtype == torch.uint16 and bins.shape == (4096, 28)
    wide = thist.widen_bins(bins)
    assert int(wide.min()) == 0 and int(wide.max()) == 1022
    assert g.shape == h.shape == m.shape == (4096,)
    assert tov._auto_bench_data(256, 28, torch.device("cpu"),
                                rows=64)[0].dtype == torch.uint8
    with pytest.raises(ValueError, match="uint8"):
        jov._auto_bench_data(1023, 28, rows=64)


def test_election_at_u16_times_the_bodies_that_serve_it(monkeypatch):
    """At B = 1,024 the election times base, staged and int8 (u8cmp and
    packed do not serve the width), on the u16 bins and the exact
    reference."""
    orig = tov._auto_bench_data
    monkeypatch.setattr(tov, "_auto_bench_data",
                        lambda mb, f, dev: orig(mb, f, dev, rows=2048))
    timed = []

    def fake_time(name, bins, g, h, m, mb, ref, iters=5):
        assert bins.dtype == torch.uint16 and ref.shape == (28, 1024, 3)
        timed.append(name)
        return {"base": 3.0, "staged": 2.0, "int8": 2.5}[name] * 1e-3, 0.0

    monkeypatch.setattr(tov, "_time_auto_candidate", fake_time)
    assert tov._run_auto_bench(1024, 28, torch.device("cpu")) == "staged"
    assert timed == ["base", "staged", "int8"]


# --------------------------------------------------------------------------
# end to end: the trees of force_row_wise at max_bin=1023
# --------------------------------------------------------------------------

_E2E_SCRIPT = r"""
import json, sys, numpy as np, jax
from unittest import mock
jax.config.update("jax_platforms", "cpu")
import lightgbm_tpu as lgb
d = np.load(sys.argv[1])
out = {}
for v, nf in json.loads(sys.argv[2]):
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "max_bin": 1023, "force_row_wise": True, "hist_variant": v}
    ds = lgb.Dataset(d[f"X{nf}"], label=d[f"y{nf}"], params=p)
    # force_row_wise picks the Pallas kernels only on a TPU backend; they
    # then run in interpret mode once the patch is gone
    with mock.patch.object(jax, "default_backend", return_value="tpu"):
        bst = lgb.Booster(params=p, train_set=ds)
    cfg = bst._gbdt._grower_cfg
    assert (cfg.hist_method, cfg.hist_variant) == ("pallas", v), cfg
    for _ in range(int(d["iters"])):
        bst.update()
    out[f"{v}_{nf}_model"] = np.array(bst.model_to_string())
    out[f"{v}_{nf}_pred"] = bst.predict(d[f"Xv{nf}"])
np.savez(sys.argv[3], **out)
"""
E2E_ITERS = 3
# (variant, features): 8 features lie inside the leaves cut at B = 1,024
# (8,192 lanes), 33 outside it (33,792)
E2E = (("staged", 8), ("int8", 8), ("base", 33))


# ~20 rows a bin at 1,023 bins: at 2,000 rows (two a bin) two thresholds
# a bin or two apart tie in gain to six digits, and the JAX kernels'
# float32 sums (int8's float32 fold, the scatter outside the cut) against
# the port's float64 ones pick one or the other
E2E_ROWS = 20_000


def _e2e_data(nf):
    rng = np.random.default_rng(nf)
    n = E2E_ROWS + 300
    X = rng.normal(size=(n, nf)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
         > 0).astype(np.float32)
    return X[:-300], y[:-300], X[-300:]


@pytest.fixture(scope="module")
def jax_e2e():
    data = {}
    for nf in sorted({nf for _, nf in E2E}):
        X, y, Xv = _e2e_data(nf)
        data.update({f"X{nf}": X, f"y{nf}": y, f"Xv{nf}": Xv})
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "in.npz"), os.path.join(td, "out.npz")
        np.savez(src, iters=E2E_ITERS, **data)
        _run_clean(_E2E_SCRIPT, [src, json.dumps(E2E), dst])
        return dict(np.load(dst))


@pytest.mark.parametrize("variant,nf", E2E)
def test_train_force_row_wise_u16_matches_jax(jax_e2e, card_dispatch,
                                              variant, nf):
    X, y, Xv = _e2e_data(nf)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "max_bin": 1023, "force_row_wise": True, "hist_variant": variant}
    ds = lgt.Dataset(X, label=y)
    bt = lgt.train(p, ds, E2E_ITERS, verbose_eval=False, device="cpu")
    cfg = bt._gbdt._grower_cfg
    assert (cfg.hist_method, cfg.hist_variant) == ("onehot", variant)
    assert ds._inner.bins.dtype == np.uint16 and cfg.max_bin == 1024
    assert thist.onehot_leaves_fits(nf, cfg.frontier_k, 1024) == (nf == 8)
    tj = _trees(str(jax_e2e[f"{variant}_{nf}_model"]))
    tt = _trees(bt.model_to_string())
    assert len(tt) == len(tj) == E2E_ITERS
    for (sj, lj), (st, lt) in zip(tj, tt):
        assert st == sj
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv),
                               jax_e2e[f"{variant}_{nf}_pred"], rtol=0,
                               atol=5e-6)
