"""PyTorch port, histograms and training above 9,685 bins against the JAX
package.

The JAX package takes any ``max_bin`` up to 65,535.  The port's atomic
kernels keep one feature group's ``[B, 3]`` float64 histogram in a CTA's
shared memory; where not even one feature's fits (24 bytes a bin, above
~8,900 bins with the staging), the plan splits each feature's bins into
bin tiles, a grid axis beside the feature groups, and each CTA adds only
its tile's rows.  On the CPU the wrappers take their plain versions, which
have no width limit.  Here:

- ``hist_full_plain`` and ``hist_leaves_plain`` at B = 12,000 equal the
  JAX package's scatter (``build_histogram(method="scatter")``,
  ``build_histogram_leaves``) exactly, on values whose sums are exact in
  float32, with bins >= B present (the JAX scatter clips them into B - 1;
  the comparison gives them a bin B of their own and cuts it off);
- the Pallas one-hot kernel (``_hist_pallas``, interpret mode, in a clean
  subprocess as ``tests/test_torch_onehot.py`` runs it) at B = 12,000
  within ``HIST_PARITY_TOL``;
- ``train`` at ``max_bin=12000`` on 40,000 x 3 rows gives the JAX
  package's trees on the frontier and on ``tree_grower=serial``, with
  predictions within 5e-6 (the bound of ``tests/test_torch_train.py``).
  At ~3 rows a bin, gains of nearby thresholds often tie to float32's
  resolution, and the JAX package's float32 sums then pick another of
  them than the port's float64 sums: on 2 of the first 4 seeds of this
  generator (and on seed 7, two thresholds 9 bins apart at gains 459.27902
  and 459.27905) one threshold differs, the predictions still within
  2.4e-7.  The data (seed 2) has no such tie, as
  ``tests/test_torch_train.py`` asks of its own;
- the tile plan (``atomic_geometry``, the C plan's arithmetic): the
  listed design's tiles of 256 bins at every width one feature's dealt CTA
  cannot hold, every bin in exactly one tile and a CTA's histogram within
  the shared memory a CTA may hold; no plan there in the designs that hold
  whole features, but one at the widest width they hold; and the float64
  partials of a call bounded by its segments (``atomic_scratch``).

The kernels themselves, bit for bit against the plain versions at B =
12,000, 16,384 and 65,536, are in ``tests/test_torch_kernels_cuda.py``.
"""
import os
import tempfile

import jax  # noqa: F401  (JAX on the CPU before the port's imports)
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu_torch.ops import histogram as thist
from test_torch_onehot import _run_clean

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

B = 12_000


def _exact_rows(rng, n):
    """g, h, m whose products and sums are exact in float32 (multiples of
    1/64 and 1/32, weights 0, 1 and 2), so that the JAX float32 scatter
    and the port's float64 sum give the same bits."""
    g = (rng.integers(-128, 128, n) / 64).astype(np.float32)
    h = (rng.integers(1, 32, n) / 32).astype(np.float32)
    m = rng.choice(np.array([0.0, 1.0, 2.0], np.float32), n)
    return g, h, m


def _wide_bins(rng, shape):
    """u16 bins in [0, B + 300): a few hundred columns' worth above B."""
    return rng.integers(0, B + 300, shape).astype(np.uint16)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_plain_versions_equal_the_jax_scatter_at_12000_bins():
    rng = np.random.default_rng(0)
    n, f = 6000, 3
    bins = _wide_bins(rng, (n, f + 2))
    g, h, m = _exact_rows(rng, n)
    got = thist.build_histogram(*_t(bins, g, h, m), B, f_limit=f).numpy()
    clip = np.where(bins < B, bins, B).astype(np.int32)[:, :f]
    ref = np.asarray(jhist.build_histogram(clip, g, h, m, B + 1,
                                           method="scatter"))[:, :B]
    assert got.shape == (f, B, 3)
    np.testing.assert_array_equal(got, ref)

    BR, k = 256, 5
    bl = np.array([2, 0, 4, 1, 2, 0, 3, 4], np.int32)      # unsorted
    comb = _wide_bins(rng, (bl.size * BR, f + 6))
    lg, lh, lm = _exact_rows(rng, bl.size * BR)
    got = thist.build_histogram_leaves(*_t(comb, lg, lh, lm, bl), k, B,
                                       block_rows=BR, f_limit=f).numpy()
    clip = np.where(comb < B, comb, B).astype(np.int32)
    ref = np.asarray(jhist.build_histogram_leaves(
        clip, lg, lh, lm, bl, k, B + 1, method="scatter", block_rows=BR,
        f_limit=f))[:, :, :B]
    assert got.shape == (k, f, B, 3)
    np.testing.assert_array_equal(got, ref)


_PALLAS_SCRIPT = r"""
import sys, numpy as np, jax
jax.config.update("jax_platforms", "cpu")
from lightgbm_tpu.ops.histogram import _hist_pallas
d = np.load(sys.argv[1])
np.save(sys.argv[2], np.asarray(_hist_pallas(
    d["bins"], d["g"], d["h"], d["m"], int(d["B"]), interpret=True)))
"""


def test_plain_version_within_the_pallas_kernel_at_12000_bins():
    """The JAX one-hot kernel in interpret mode (bf16 pair) against the
    port's plain version, bins >= B dropped by both."""
    rng = np.random.default_rng(1)
    n, f = 1024, 2
    bins = _wide_bins(rng, (n, f))
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    m = (rng.random(n) > 0.1).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        src, dst = os.path.join(td, "in.npz"), os.path.join(td, "out.npy")
        np.savez(src, bins=bins, g=g, h=h, m=m, B=B)
        _run_clean(_PALLAS_SCRIPT, [src, dst])
        ref = np.load(dst)
    got = thist.build_histogram(*_t(bins, g, h, m), B).numpy()
    assert got.shape == ref.shape == (f, B, 3)
    err = np.abs(got - ref) / (np.abs(ref) + 1.0)
    assert float(err.max()) <= thist.HIST_PARITY_TOL


@pytest.mark.parametrize("grower", ["frontier", "serial"])
def test_train_at_max_bin_12000_matches_jax(grower):
    """The port trains at a width the card's kernels split into bin tiles,
    on the CPU, and grows the JAX package's trees."""
    rng = np.random.default_rng(2)
    n = 40_000
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
         > 0).astype(np.float32)
    params = {"objective": "binary", "max_bin": 12000, "num_leaves": 15,
              "tree_grower": grower, "verbose": -1}
    bj = lgb.train(params, lgb.Dataset(X, label=y, params=params), 2,
                   verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(X, label=y, params=params), 2,
                   verbose_eval=False, device="cpu")
    width = bt._gbdt._grower_cfg.max_bin
    assert width > 9685 and thist.atomic_geometry(3, width, 3, 2)["tiles"] > 1
    for tj, tt in zip(bj._gbdt.models, bt._gbdt.models):
        assert tj.num_leaves == tt.num_leaves == 15
        np.testing.assert_array_equal(tt.split_feature, tj.split_feature)
        np.testing.assert_array_equal(tt.threshold, tj.threshold)
    Xv = X[:2000]
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)


# (f, B, stride, esz): 28 features at B = 12,000, 16,384 and 65,536 in the
# full pass's rows (28 u16) and the frontier's comb (34), 3 features at an
# odd width, a 1-feature matrix of narrow rows (span staging)
TILED = [(28, 12_000, 28, 2), (28, 16_384, 34, 2), (28, 65_536, 28, 2),
         (28, 65_536, 34, 2), (3, 12_001, 9, 2), (1, 65_536, 1, 2)]


@pytest.mark.parametrize("f,width,stride,esz", TILED)
def test_bin_tiles_cover_every_bin_once_and_fit_a_cta(f, width, stride,
                                                      esz):
    geo = thist.atomic_geometry(f, width, stride, esz)
    # the listed design: a unit a warp of one feature's tile of 256 bins
    assert geo["tiles"] > 1 and geo["fg"] == 1 and geo["design"] == 2
    assert geo["tile_bins"] == 256 and geo["tile"] == thist.LIST_UNIT
    tiles, bt = geo["tiles"], geo["tile_bins"]
    # bin b lies in tile b // bt, and only there; no tile is empty
    edges = [min(t * bt, width) for t in range(tiles + 1)]
    assert edges[0] == 0 and edges[-1] == width
    assert all(a < b for a, b in zip(edges, edges[1:]))
    assert geo["dynamic_smem_bytes"] <= thist.SMEM_MAX_BYTES
    # the dealt design holds whole features: none at this width, and one
    # at the widest width it holds, in one tile within shared memory
    with pytest.raises(ValueError, match="no dealt plan"):
        thist.atomic_geometry(f, width, stride, esz, "dealt")
    widest = max(B for B in range(8_000, 9_700, 4)
                 if thist._plan_geometry(1, B, stride, esz, True))
    one = thist.atomic_geometry(1, widest, stride, esz, "dealt")
    assert one["tiles"] == 1 and one["tile_bins"] == widest
    assert one["dynamic_smem_bytes"] <= thist.SMEM_MAX_BYTES


def test_tiled_scratch_is_bounded_by_a_wave_of_tiles():
    """The float64 partials of a call at f = 28, B = 65,536 on a card of
    132 SMs: the listed design holds one [256, 3] sum a segment (a slot's
    tile of a feature, 256 tiles a feature), touched only where a segment
    is split into units, whatever the rows: one [B, 3] partial a feature
    and slot (44 MB for K1, 705 MB for K2's 16 slots), not the ~5.8 GB of
    132 whole-width partials a CTA each would take."""
    f, width = 28, 65_536
    for kernel, stride, units, k in (("hist_full", 28, 1_000_000, 1),
                                     ("hist_leaves", 34, 512, 16)):
        listed = thist.atomic_geometry(f, width, stride, 2)
        assert listed["design"] == 2 and listed["tiles"] == 256
        new = thist.atomic_scratch(kernel, {**listed, "ctas_per_sm": 4,
                                            "sms": 132}, f, width, units, k)
        assert new["partial_bytes"] == f * k * width * 24
        assert new["partial_bytes"] <= (50e6 if kernel == "hist_full"
                                        else 750e6)
        assert new["partial_bytes"] < 132 * f * width * 24
