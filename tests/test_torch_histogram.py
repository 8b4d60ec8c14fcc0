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


def _zipf_u16(rng, shape, B, a=1.1, past=0.03):
    """u16 bins in [0, B), bin i drawn with weight 1/(i+1)^a (an EFB
    bundle's skew: a few bins hold most rows), and a share ``past`` of them
    raised to B..65,535 (past the kernels' range: dropped)."""
    p = 1.0 / np.arange(1, B + 1) ** a
    b = rng.choice(B, shape, p=p / p.sum()).astype(np.uint16)
    high = rng.random(shape) < past
    b[high] = rng.integers(B, 65_536, int(high.sum()))
    return b


def _scatter_in_range(bins, g, h, m, B):
    """The JAX scatter per feature over the rows whose bin for it is below
    B: it clips the others into bin B - 1, where the port drops them (as
    the Pallas kernels do), so those rows are given no weight."""
    return np.concatenate([np.asarray(jhist._hist_scatter(
        bins[:, j:j + 1], g, h, np.where(bins[:, j] < B, m, 0.0)
        .astype(np.float32), B)) for j in range(bins.shape[1])])


# (max_bin, bin type): u8 at 64 and 256 bins; u16 at B = 1,024
# (max_bin=1023) and at the sparse_efb bundle width (2,599), with
# Zipf-skewed bins, some of them past B
HIST_WIDTHS = [pytest.param(64, "u8", id="64"),
               pytest.param(256, "u8", id="256"),
               (1024, "u16"), (2599, "u16")]


@pytest.mark.parametrize("max_bin,kind", HIST_WIDTHS)
def test_build_histogram_plain_matches_scatter(max_bin, kind):
    rng = np.random.default_rng(max_bin)
    n, f = 3000, 7
    g, h, m = _rows(rng, n)
    if kind == "u8":
        bins = rng.integers(0, max_bin, (n, f)).astype(np.uint8)
        ref = np.asarray(jax.jit(jhist._hist_scatter, static_argnums=4)(
            bins, g, h, m, max_bin))
    else:
        bins = _zipf_u16(rng, (n, f), max_bin)
        ref = _scatter_in_range(bins, g, h, m, max_bin)
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


def _leaves_scatter_in_range(comb, g, h, m, bl, k, B, BR, f):
    """The JAX per-leaf scatter per feature, the rows whose bin for it is
    past B given no weight (see _scatter_in_range)."""
    return np.concatenate([np.asarray(jhist.build_histogram_leaves(
        comb[:, j:j + 1], g, h, np.where(comb[:, j] < B, m, 0.0)
        .astype(np.float32), bl, k, B, method="scatter", block_rows=BR,
        f_limit=1)) for j in range(f)], axis=1)


# (B, bin type): u8 at 64 bins; u16 at 1,024 and 2,599 (Zipf-skewed, some
# bins past B; the frontier's 6 u16 gh columns past f_limit)
LEAVES_WIDTHS = [pytest.param(64, "u8", id="64"), (1024, "u16"),
                 (2599, "u16")]


@pytest.mark.parametrize("B,kind", LEAVES_WIDTHS)
def test_build_histogram_leaves_plain_matches_xla(B, kind):
    rng = np.random.default_rng(11)
    comb, g, h, m, bl, k, BR, f = _leaves_case(rng)
    if kind == "u8":
        ref = np.asarray(jhist.build_histogram_leaves(
            comb, g, h, m, bl, k, B, method="scatter", block_rows=BR,
            f_limit=f))
    else:
        comb = np.concatenate([_zipf_u16(rng, (comb.shape[0], f), B),
                               rng.integers(0, 65_536, (comb.shape[0], 6))
                               .astype(np.uint16)], axis=1)
        comb[4 * BR + 5, :f] = 0            # the NaN row's bins in range
        ref = _leaves_scatter_in_range(comb, g, h, m, bl, k, B, BR, f)
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
    bl = torch.zeros(2, dtype=torch.int32)
    thist.reset_launch_counts()
    for method, variant in (("atomic", "base"), ("onehot", "base"),
                            ("onehot", "int8")):
        thist.build_histogram(*_t(bins, g, h, m), 16, method=method,
                              variant=variant)
        thist.build_histogram_leaves(*_t(bins, g, h, m), bl, 1, 16,
                                     block_rows=128, method=method,
                                     variant=variant)
    assert set(thist.launch_counts) == {"hist_full", "hist_leaves",
                                        "onehot_full", "onehot_leaves",
                                        "onehot_quant", "onehot_bench"}
    assert not any(thist.launch_counts.values())
    with pytest.raises(ValueError, match="CUDA"):
        thist.hist_full(*_t(bins, g, h, m), 16)
    with pytest.raises(ValueError, match="CUDA"):
        thist.hist_leaves(*_t(bins, g, h, m), bl, 1, 16, block_rows=128)
    with pytest.raises(ValueError, match="CUDA"):
        thist.hist_onehot_full(*_t(bins, g, h, m), 16)
    with pytest.raises(ValueError, match="CUDA"):
        thist.hist_onehot_leaves(*_t(bins, g, h, m), bl, 1, 16,
                                 block_rows=128)
    with pytest.raises(ValueError, match="CUDA"):
        thist.quantize_int8_blocks(torch.zeros(3, 256), 128)
    assert not any(thist.launch_counts.values())


def test_force_plain_is_scoped():
    assert not thist._force_plain
    with thist.force_plain():
        assert thist._force_plain
    assert not thist._force_plain


def test_atomic_design_is_scoped_and_checked():
    """The atomic kernels' design override (for timing one design against
    the other) holds inside its block only and names a known design."""
    assert thist._atomic_design is None
    with thist.atomic_design("dealt"):
        assert thist._atomic_design == "dealt"
        with thist.atomic_design("owned"):
            assert thist._atomic_design == "owned"
        assert thist._atomic_design == "dealt"
    assert thist._atomic_design is None
    with pytest.raises(ValueError, match="unknown atomic design"):
        with thist.atomic_design("shared"):
            pass
    assert thist._atomic_design is None


@pytest.mark.parametrize("units,align,ctas_per_sm,sms,groups", [
    (1_000_000, 16, 1, 132, 1),       # the full pass's rows
    (512, 1, 1, 132, 1),              # one frontier round's blocks
    (5, 1, 1, 132, 1),                # fewer units than CTAs
    (3_001, 16, 2, 132, 24),          # wide rows: 24 feature groups
    (700, 1, 0, 132, 200),            # more groups than CTAs at once
    (1, 16, 1, 132, 1),               # one row: a share of one align
    (1_953, 1, 3, 132, 2)])           # several CTAs an SM
def test_atomic_grid_covers_every_unit_once(units, align, ctas_per_sm, sms,
                                            groups):
    """The atomic kernels' split of rows (or blocks) over CTAs: every unit
    in exactly one CTA's share, shares a multiple of ``align``, no CTA
    without units, and no more CTAs along x than the card holds at once
    over the feature groups."""
    plan = {"ctas_per_sm": ctas_per_sm, "sms": sms, "groups": groups}
    grid_x, per = thist.atomic_grid(plan, units, align)
    assert per % align == 0 and per >= 1
    assert (grid_x - 1) * per < units <= grid_x * per
    assert grid_x <= max(1, max(1, ctas_per_sm) * sms // groups)


def test_atomic_plan_refuses_a_width_shared_memory_cannot_hold():
    """A bin width whose one-feature histogram exceeds a CTA's shared
    memory is refused before any kernel is built (so also here, without
    a card)."""
    with pytest.raises(ValueError, match="max_bin=20000"):
        thist.atomic_plan("hist_full", torch.device("cuda", 0), 28, 28,
                          20_000)
    assert not thist._plans
