"""PyTorch port, split search: the same ``SplitResult`` as the JAX package.

Histograms are built with numpy from random rows (made from a seed) so that
they are consistent (every feature sums to the leaf totals), then searched
by both packages.  The port searches a batch of leaves in one call; the
JAX function runs once per leaf.  Feature, threshold and missing direction
must agree exactly; gains, sums and outputs to 1e-5 relative (the two
frameworks round the same f32 formulas the same way up to cumsum order).
"""
import jax
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit

pytestmark = pytest.mark.torch_port
# one intra-op thread each: the suite runs in several worker processes
torch.set_num_threads(1)

F, B = 6, 32
NUM_BINS = np.array([32, 20, 9, 32, 14, 3], np.int32)


def _params(**kw):
    base = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20,
                min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                max_delta_step=0.0, path_smooth=0.0, cat_smooth=10.0,
                cat_l2=10.0, max_cat_to_onehot=4)
    base.update(kw)
    return jsplit.SplitParams(**base), tsplit.SplitParams(**base)


def _leaves(seed, nan_bins, n_leaves=3):
    rng = np.random.default_rng(seed)
    hists, tots = [], []
    for s in range(n_leaves):
        n = int(rng.integers(200, 1500))
        bins = np.stack([rng.integers(0, nb, n) for nb in NUM_BINS], 1)
        g = rng.normal(size=n).astype(np.float32) + 0.3 * (bins[:, s] > 4)
        h = rng.uniform(0.1, 0.25, n).astype(np.float32)
        hist = np.zeros((F, B, 3), np.float32)
        for f in range(F):
            np.add.at(hist[f], bins[:, f], np.stack([g, h, np.ones(n)], 1))
        hists.append(hist)
        tots.append((np.float32(g.sum()), np.float32(h.sum()),
                     np.float32(n)))
    return np.stack(hists), np.array(tots, np.float32)


def _jax_one(hist, tot, nan_bins, pj, fmask):
    z = np.zeros(F, np.int32)
    return jax.device_get(jsplit.find_best_split(
        hist, NUM_BINS, z, nan_bins, np.zeros(F, bool), np.zeros(F, np.int8),
        tot[0], tot[1], tot[2], pj, fmask, sorted_cat=False))


NAN_CASES = {
    "no_missing": np.full(F, -1, np.int32),
    # trailing NaN bins on two features, a mid-range zero-as-missing bin
    "missing": np.array([31, -1, 8, 5, -1, 2], np.int32),
}
PARAM_CASES = {
    "default": {},
    "l1_l2": {"lambda_l1": 0.5, "lambda_l2": 2.0},
    "max_delta_step": {"max_delta_step": 0.05},
    "path_smooth": {"path_smooth": 3.0},
    "min_gates": {"min_data_in_leaf": 150, "min_sum_hessian_in_leaf": 30.0,
                  "min_gain_to_split": 0.5},
}


@pytest.mark.parametrize("nan_case", list(NAN_CASES))
@pytest.mark.parametrize("param_case", list(PARAM_CASES))
def test_find_best_split_matches_jax(nan_case, param_case):
    nan_bins = NAN_CASES[nan_case]
    pj, pt = _params(**PARAM_CASES[param_case])
    hists, tots = _leaves(len(param_case) * 7 + len(nan_case), nan_bins)
    fmask = np.ones(F, np.float32)
    fmask[4] = 0.0
    got = tsplit.find_best_split(
        torch.as_tensor(hists), torch.as_tensor(NUM_BINS),
        torch.as_tensor(nan_bins), torch.as_tensor(tots[:, 0]),
        torch.as_tensor(tots[:, 1]), torch.as_tensor(tots[:, 2]), pt,
        torch.as_tensor(fmask))
    n_split = 0
    for s in range(hists.shape[0]):
        ref = _jax_one(hists[s], tots[s], nan_bins, pj, fmask)
        if ref.gain <= jsplit.NEG_INF / 2:
            assert got.gain[s] <= tsplit.NEG_INF / 2
            continue
        n_split += 1
        assert int(got.feature[s]) == int(ref.feature) != 4
        assert int(got.threshold[s]) == int(ref.threshold)
        assert bool(got.default_left[s]) == bool(ref.default_left)
        for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                     "right_sum_g", "right_sum_h", "right_count",
                     "left_output", "right_output"):
            np.testing.assert_allclose(float(getattr(got, name)[s]),
                                       float(getattr(ref, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        assert not np.asarray(got.cat_bits[s]).any()
    if param_case != "min_gates":
        assert n_split == hists.shape[0]


def test_missing_direction_is_exercised():
    """The missing case must actually pick default_left somewhere, or the
    parity above would not cover the left sweep."""
    nan_bins = NAN_CASES["missing"]
    _, pt = _params()
    seen = set()
    for seed in range(12):
        hists, tots = _leaves(100 + seed, nan_bins)
        hists[:, 0, 31, 0] += 25.0                    # heavy NaN-bin gradient
        tots[:, 0] += 25.0
        r = tsplit.find_best_split(
            torch.as_tensor(hists), torch.as_tensor(NUM_BINS),
            torch.as_tensor(nan_bins), torch.as_tensor(tots[:, 0]),
            torch.as_tensor(tots[:, 1]), torch.as_tensor(tots[:, 2]), pt,
            torch.ones(F))
        seen.update(bool(v) for v in r.default_left)
    assert seen == {True, False}


def test_leaf_output_and_gain_match_jax():
    rng = np.random.default_rng(3)
    g = rng.normal(size=50).astype(np.float32) * 10
    h = rng.uniform(1, 20, 50).astype(np.float32)
    c = rng.integers(1, 100, 50).astype(np.float32)
    for kw in ({}, {"lambda_l1": 1.0, "lambda_l2": 3.0},
               {"max_delta_step": 0.2, "path_smooth": 5.0}):
        pj, pt = _params(**kw)
        for fn in ("leaf_output", "leaf_gain"):
            ref = np.asarray(getattr(jsplit, fn)(g, h, pj, 0.0, c))
            got = getattr(tsplit, fn)(*map(torch.as_tensor, (g, h)), pt,
                                      0.0, torch.as_tensor(c)).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
