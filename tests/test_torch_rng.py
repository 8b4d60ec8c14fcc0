"""PyTorch port, the counter-based draws against ``jax.random``.

``lightgbm_tpu_torch.utils.random_gen`` computes threefry2x32 keys and
float32 uniforms as torch ops; they must be bit-identical to jax 0.9.0's
(``jax_threefry_partitionable=True``) for every seed, salt and length, and
the grower's per-node draws built on them (``node_feature_mask_for``,
``rand_thresholds_for``) and the monotone penalty must equal the JAX
package's, and so must the trees that ``feature_fraction_bynode`` and
``extra_trees`` grow from them (held as ``tests/test_torch_train.py``
holds the default run: the same model text apart from float digits, leaf
values within 1e-5, predictions within 5e-6).  The same draws on the card
are checked by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops import grower as jgrow
from lightgbm_tpu.utils.random_gen import key_for_iteration as jkey
from lightgbm_tpu_torch.ops import grower as tgrow
from lightgbm_tpu_torch.utils import random_gen as trng
from test_torch_train import PARAMS, _assert_same_model_text, _data

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)


@pytest.mark.parametrize("seed,it,salt,n", [
    (3, 0, 0, 10), (42, 7, 1, 1001), (0, 123, 3, 4097),
    (2, 5, 0, 70_001),               # odd, and over 2**16 counters
    (2**32 - 1, 9, 2, 3), (11, 2**31 + 5, 17, 1)])
def test_key_and_uniform_match_jax(seed, it, salt, n):
    kj = jkey(seed, it, salt)
    kt = trng.key_for_iteration(seed, it, salt)
    np.testing.assert_array_equal(
        kt.numpy(), np.asarray(jax.random.key_data(kj)).astype(np.int64))
    np.testing.assert_array_equal(trng.uniform(kt, n).numpy(),
                                  np.asarray(jax.random.uniform(kj, (n,))))


def test_fold_in_over_a_batch_matches_jax():
    """One set of ops draws for every key of a batch."""
    kj = jkey(4, 2, 1)
    steps = np.array([0, 1, 2, 7, 31, 4096, 2**32 - 1], np.int64)
    kt = trng.fold_in(trng.key_for_iteration(4, 2, 1), torch.as_tensor(steps))
    u = trng.uniform(kt, 33).numpy()
    assert u.shape == (len(steps), 33)
    for i, s in enumerate(steps):
        kjs = jax.random.fold_in(kj, np.uint32(s))
        np.testing.assert_array_equal(
            kt[i].numpy(), np.asarray(jax.random.key_data(kjs)).astype(np.int64))
        np.testing.assert_array_equal(
            u[i], np.asarray(jax.random.uniform(kjs, (33,))))


@pytest.mark.parametrize("frac", [0.5, 0.8])
def test_node_draws_match_jax(frac):
    f = 13
    num_bins = np.array([2, 3, 16, 256, 40, 9, 64, 5, 100, 7, 33, 2, 255],
                        np.int32)
    nan_bins = np.where(np.arange(f) % 3 == 0, num_bins - 1, -1).astype(
        np.int32)
    fmask = np.ones(f, np.float32)
    fmask[[2, 5, 11]] = 0.0                 # thinned by feature_fraction
    kj, kt = jkey(9, 4, 2), trng.key_for_iteration(9, 4, 2)
    steps = np.arange(0, 40, 3)
    st = torch.as_tensor(steps)
    masks = tgrow.node_feature_mask_for(kt, st, torch.as_tensor(fmask), frac)
    thr = tgrow.rand_thresholds_for(kt, st, 6, torch.as_tensor(num_bins),
                                    torch.as_tensor(nan_bins))
    for i, s in enumerate(steps):
        np.testing.assert_array_equal(
            masks[i].numpy(),
            np.asarray(jgrow.node_feature_mask_for(kj, s, fmask, frac)))
        np.testing.assert_array_equal(
            thr[i].numpy(),
            np.asarray(jgrow.rand_thresholds_for(kj, s, 6, num_bins,
                                                 nan_bins)))
    assert ((masks.numpy() > 0) <= (fmask > 0)).all()


@pytest.mark.parametrize("pen", [0.5, 1.0, 2.5])
def test_monotone_gain_mult_matches_jax(pen):
    mono = np.array([1, 0, -1, 0, 1], np.int8)
    depth = np.arange(6)
    got = tgrow.monotone_gain_mult(torch.as_tensor(depth),
                                   torch.as_tensor(mono), pen).numpy()
    for i, d in enumerate(depth):
        np.testing.assert_array_equal(
            got[i], np.asarray(jgrow.monotone_gain_mult(d, mono, pen)))


@pytest.mark.parametrize("knob", [
    {"feature_fraction_bynode": 0.5},
    {"extra_trees": True, "feature_fraction": 0.75}],
    ids=["bynode", "extra_trees"])
def test_per_node_draws_train_like_jax(knob):
    X, y, Xv, _ = _data(0)
    params = {**PARAMS, **knob}
    bj = lgb.train(params, lgb.Dataset(X, label=y), 6, verbose_eval=False)
    bt = lgt.train(params, lgt.Dataset(X, label=y), 6, verbose_eval=False,
                   device="cpu")
    _assert_same_model_text(bj.model_to_string(), bt.model_to_string())
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=5e-6)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))
