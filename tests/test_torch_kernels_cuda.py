"""PyTorch port, the hand-written CUDA kernels on the card.

The kernels have no CPU mode, so every test here needs a CUDA card and
skips without one.  This file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  Each kernel is held
against its plain PyTorch version on the same CUDA tensors at relative
error ``|a-b|/(|b|+1)`` <= 1e-5: both sum in float64 and round once, so only
the summation order differs (the bf16 one-hot kernels also sum each 128-row
chunk's tensor-core products in float32 first, which is exact for the few
rows of one chunk that share a bin; the int8 kernels' int32 sums are exact).
A non-finite value makes its channel NaN in the one-hot product, and the
plain versions put the NaN in the same places.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import onehot_variants as ov

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


# the atomic kernels sum in float64 and round once, as their plain
# versions do: at most one float32 rounding step apart
ATOMIC_TOL = 1.2e-7


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _hold_atomic(got, again, ref):
    """Within one rounding step of the plain version on its finite entries,
    NaN where it is NaN, and the same bits from a second call."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert torch.equal(got[~fin & ~torch.isnan(ref)],
                       ref[~fin & ~torch.isnan(ref)])     # the infinities
    assert relerr(got[fin], ref[fin]) <= ATOMIC_TOL
    assert _same_bits(got, again)


def _edge_rows(rng, case, n, ncols, dev):
    bins = rng.integers(0, 256, (n, ncols)).astype(np.uint8)
    if case == "one_bin":                       # every row in one bin
        bins[:] = 3
    g, h, m = _rows(rng, n, dev)                # weights 0, 1 and 2.5
    if case == "nonfinite":
        g[5], h[9], g[n // 2] = float("nan"), float("inf"), float("-inf")
    return torch.as_tensor(bins).to(dev), g, h, m


# (case, n, f, ncols, B): rows in one bin; B = 64 and 255; f = 13 with
# wider rows; row counts that are no multiple of a tile or of a CTA's
# share; fewer rows than one step; NaN and inf; rows wide enough to be
# staged row by row, over feature groups (the last one narrower)
FULL_ATOMIC_EDGES = [("one_bin", 5_000, 5, 5, 64),
                     ("random", 20_003, 13, 20, 64),
                     ("random", 33_333, 28, 40, 255),
                     ("random", 17, 3, 7, 16),
                     ("nonfinite", 9_999, 13, 16, 255),
                     ("random", 3_001, 700, 701, 256),
                     ("random", 1_000, 2000, 2003, 256)]


@pytest.mark.parametrize("case,n,f,ncols,B", FULL_ATOMIC_EDGES)
def test_hist_full_edges_match_plain(dev, case, n, f, ncols, B):
    rng = np.random.default_rng(n + B)
    bins, g, h, m = _edge_rows(rng, case, n, ncols, dev)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    got = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    again = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    torch.cuda.synchronize()
    assert got.shape == (f, B, 3)
    _hold_atomic(got, again, ref)
    if case == "nonfinite":     # NaN only in the three rows' own bins
        assert 0 < int(torch.isnan(got).sum()) <= 3 * f


def _leaf_map(rng, case, nb, k):
    if case == "one_slot":                      # every run crosses CTAs
        return np.zeros(nb, np.int32)
    if case == "alternating":                   # each slot met again
        return (np.arange(nb) % 2).astype(np.int32)
    if case == "slot_ordered":                  # as the frontier lays it
        return np.sort(rng.integers(0, k, nb)).astype(np.int32)
    # random slots, two of them never named, blocks outside [0, k)
    bl = rng.integers(0, k - 2, nb).astype(np.int32)
    bl[3], bl[nb // 2] = -1, k
    return bl


# (map case, bins case, k, BR, nb, f, nc, B): k = 1 with one slot's run
# split over many CTAs (each starts and ends inside it); k = 64 with
# empty slots and dropped blocks; the frontier's slot order; rows in one
# bin; NaN and inf; B = 64 and 255; two slots in turn, so a CTA adds runs
# of a slot it has met before into that slot's one partial (slot 2
# empty); wide rows staged row by row, over feature groups, and at B = 64
# warps that own several features
LEAVES_ATOMIC_EDGES = [("one_slot", "random", 1, 64, 700, 13, 20, 255),
                       ("random", "random", 64, 128, 300, 28, 40, 255),
                       ("slot_ordered", "random", 16, 512, 90, 28, 40, 64),
                       ("slot_ordered", "one_bin", 8, 256, 40, 5, 9, 64),
                       ("random", "nonfinite", 10, 100, 50, 13, 16, 255),
                       ("alternating", "random", 3, 64, 600, 13, 20, 255),
                       ("slot_ordered", "random", 4, 128, 24, 700, 712,
                        256),
                       ("random", "random", 16, 64, 40, 300, 301, 64)]


@pytest.mark.parametrize("map_case,bin_case,k,BR,nb,f,nc,B",
                         LEAVES_ATOMIC_EDGES)
def test_hist_leaves_edges_match_plain(dev, map_case, bin_case, k, BR, nb, f,
                                       nc, B):
    rng = np.random.default_rng(nb + k)
    C = nb * BR
    comb, g, h, m = _edge_rows(rng, bin_case, C, nc, dev)
    block_leaf = _leaf_map(rng, map_case, nb, k)
    bl = torch.as_tensor(block_leaf).to(dev)
    kw = dict(block_rows=BR, f_limit=f)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert got.shape == (k, f, B, 3)
    _hold_atomic(got, again, ref)
    for s in set(range(k)) - set(block_leaf.tolist()):
        assert bool((got[s] == 0).all())        # a slot no block names
    if map_case in ("one_slot", "alternating"):
        plan = thist.atomic_plan("hist_leaves", comb.device, nc, f, B)
        bpc = thist.atomic_grid(plan, nb)[1]
        assert 1 < bpc < nb                     # CTAs split the blocks
    if bin_case == "nonfinite":                 # each in its row's slot
        for r in (5, 9, C // 2):
            s = int(block_leaf[r // BR])
            if 0 <= s < k:
                assert not bool(torch.isfinite(got[s]).all())


def test_atomic_plan_holds_the_main_path_in_one_group(dev):
    """At F = 28, B = 256 one CTA holds every feature (rows read once),
    with no spill; the kernels launch through it."""
    for kernel, units, stride in (("hist_full", 1_000_000, 28),
                                  ("hist_leaves", 512, 40)):
        plan = thist.atomic_plan(kernel, dev, stride, 28, 256)
        assert plan["fg"] == 28 and 0 < plan["threads"] <= 28 * 32
        assert plan["threads"] % 32 == 0
        assert plan["ctas_per_sm"] >= 1 and plan["local_bytes"] == 0
        assert plan["registers"] > 0 and plan["sms"] >= 1
        assert thist.atomic_grid(plan, units)[0] >= 1


@pytest.mark.parametrize("kernel", ("hist_full", "hist_leaves"))
@pytest.mark.parametrize("f", (700, 2000))
def test_atomic_plan_narrows_groups_before_tiles_on_wide_rows(dev, kernel,
                                                              f):
    """Wide rows take narrower feature groups, not tiles of a few rows:
    at B = 256 a group holds 16 to 32 features and a tile at least 128
    rows, with no spill, and the groups keep at least three quarters of
    the card's CTA slots busy (f = 2000: 125 groups of 16, not 67 of 30)."""
    plan = thist.atomic_plan(kernel, dev, f + 12, f, 256)
    assert plan["tile"] >= 128 and 16 <= plan["fg"] <= 32
    assert plan["groups"] == -(-f // plan["fg"])
    assert plan["local_bytes"] == 0
    slots = plan["ctas_per_sm"] * plan["sms"]
    grid_x = thist.atomic_grid(plan, 10 ** 6)[0]
    ctas = grid_x * plan["groups"]
    assert ctas / (-(-ctas // slots) * slots) >= 0.75


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
    with pytest.raises(ValueError, match="max_bin"):
        thist.hist_full(bins, z, z, z, 70_000)


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
    assert not any(thist.launch_counts.values())
    for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
        assert np.array_equal(tk.split_feature, tp.split_feature)
        assert np.array_equal(tk.threshold, tp.threshold)
    np.testing.assert_allclose(bk.predict(X[:2000]), bp.predict(X[:2000]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("esz", (1, 2))
def test_zero_rows_give_zeros_without_a_launch(dev, esz):
    """A rank of a row-sharded learner may hold no rows of a leaf: K1 on no
    rows and K2 on no blocks return zeros and launch nothing."""
    dt = torch.uint8 if esz == 1 else torch.uint16
    B = 256 if esz == 1 else 1024
    bins = torch.zeros(0, 28, dtype=dt, device=dev)
    v = torch.zeros(0, device=dev)
    thist.reset_launch_counts()
    full = thist.hist_full(bins, v, v, v, B)
    leaves = thist.hist_leaves(bins, v, v, v,
                               torch.zeros(0, dtype=torch.int32, device=dev),
                               16, B)
    torch.cuda.synchronize()
    assert not any(thist.launch_counts.values())
    assert full.shape == (28, B, 3) and leaves.shape == (16, 28, B, 3)
    assert not full.any() and not leaves.any()


def test_collectives_on_a_world_one_nccl_group(dev):
    """The parallel learners' collective helper on an NCCL group of one
    rank: every collective goes to NCCL and gives back its input."""
    import socket
    from lightgbm_tpu_torch.parallel import mesh as pmesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pmesh.init_distributed(f"127.0.0.1:{port}", 1, 0, timeout_secs=120,
                           backend="nccl")
    try:
        m = pmesh.default_mesh()
        assert m.backend == "nccl"
        x = torch.arange(8, dtype=torch.float32, device=dev) - 3.0
        for got in (m.all_reduce(x), m.all_reduce(x, "max"),
                    m.all_reduce(x, "min"),
                    m.reduce_scatter(x.reshape(4, 2)).reshape(-1),
                    m.all_gather(x)[0], m.broadcast(x, 0)):
            assert torch.equal(got, x)
        assert m.stats["calls"] == 6
    finally:
        pmesh.free_network()


# every one-hot body at each width it serves (packed only at B=64)
ONEHOT_CASES = [(v, B) for B in (64, 256) for v in ov.VARIANT_NAMES
                if ov.VARIANTS[v].kernel_id is not None
                and ov.VARIANTS[v].supports(B)]


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("variant,B", ONEHOT_CASES)
def test_onehot_full_matches_plain(dev, variant, B, layout):
    rng = np.random.default_rng(B)
    n, f, ncols = 50_003, 13, 16               # ragged rows, f_limit < NC
    bins = torch.as_tensor(rng.integers(0, 256, (n, ncols)).astype(np.uint8)
                           ).to(dev)                  # bins >= B are dropped
    g, h, m = _rows(rng, n, dev)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, f_limit=f,
                                    method="onehot", variant=variant,
                                    layout=layout)
    before = dict(thist.launch_counts)
    got = thist.build_histogram(bins, g, h, m, B, f_limit=f, method="onehot",
                                variant=variant, layout=layout)
    again = thist.build_histogram(bins, g, h, m, B, f_limit=f,
                                  method="onehot", variant=variant,
                                  layout=layout)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_full"] == before["onehot_full"] + 2
    assert thist.launch_counts["hist_full"] == before["hist_full"]
    assert got.shape == (f, B, 3) and got.dtype == torch.float32
    assert relerr(got, ref) <= TOL
    assert torch.equal(got, again)                 # the same bits twice


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("variant,B", ONEHOT_CASES)
def test_onehot_full_nan_matches_plain(dev, variant, B, layout):
    """A NaN gradient covers the gradient channel of the whole histogram,
    in the kernel and in the plain version alike."""
    rng = np.random.default_rng(B + 1)
    n, f = 20_000, 9
    bins = torch.as_tensor(rng.integers(0, B, (n, f)).astype(np.uint8)
                           ).to(dev)
    g, h, m = _rows(rng, n, dev)
    g[12_345] = float("nan")
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, method="onehot",
                                    variant=variant, layout=layout)
    got = thist.build_histogram(bins, g, h, m, B, method="onehot",
                                variant=variant, layout=layout)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[..., 0]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert relerr(got[..., 1:], ref[..., 1:]) <= TOL


@pytest.mark.parametrize("variant,B", ONEHOT_CASES)
def test_onehot_leaves_matches_plain(dev, variant, B):
    """An empty slot stays zero and a NaN stays in its slot.  Inside that
    slot the NaN covers its channel (0 * NaN in the tensor cores), in the
    kernel and the plain version alike; the other two channels agree."""
    rng = np.random.default_rng(17)
    k, BR, f, nc = 6, 512, 28, 40
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
                                           block_rows=BR, f_limit=f,
                                           method="onehot", variant=variant)
    before = thist.launch_counts["onehot_leaves"]
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B,
                                       block_rows=BR, f_limit=f,
                                       method="onehot", variant=variant)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B,
                                         block_rows=BR, f_limit=f,
                                         method="onehot", variant=variant)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_leaves"] == before + 2
    assert got.shape == (k, f, B, 3)
    assert bool((got[3] == 0).all())                      # empty slot
    nan_slot = int(block_leaf[nan_block])
    assert bool(torch.isnan(got[nan_slot][..., 0]).all())
    others = [s for s in range(k) if s != nan_slot]
    assert bool(torch.isfinite(got[others]).all())        # NaN stays put
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL
    assert torch.equal(got[others], again[others])
    assert torch.equal(got[nan_slot][..., 1:], again[nan_slot][..., 1:])


# the edges of the one-hot kernels' design (onehot_common.cuh): every
# bf16 body and int8 at a Bp = 256 width with bins >= B, a Bp = 128 width
# with bins >= Bp, and packed at B = 64, 16 (a tile in one feature) and 8
# (a tile spanning two); int8 also at quantization blocks of 1, 3 and 8
# chunks and a q whose row length is no multiple of 16 (n = 1037, 515)
EDGE_CASES = [(v, B) for v in ov.VARIANT_NAMES
              for B in ((64, 16, 8) if v == "packed" else (255, 100))]


def _edge_bins(rng, case, n, ncols):
    if case == "one_bin":                       # all rows in one bin
        return np.full((n, ncols), 7, np.uint8)
    if case == "one_hi_digit":                  # bins 32..47 only
        return rng.integers(32, 48, (n, ncols)).astype(np.uint8)
    return rng.integers(0, 256, (n, ncols)).astype(np.uint8)


# (case, n, f, ncols): fewer rows than one 128-row chunk; a ragged last
# chunk with f * lanes not a multiple of a CTA's 512 lanes; one bin; one
# hi digit; rows wider than the kernels stage as they lie; more features
# a CTA than a chunk has 16-byte pieces a thread (packed at B = 16 and 8:
# 32 and 40 features, 8 pieces each)
FULL_EDGES = [("tiny", 100, 3, 5), ("ragged", 1037, 5, 7),
              ("one_bin", 700, 5, 5), ("one_hi_digit", 515, 5, 6),
              ("wide", 400, 5, 300), ("many_features", 1037, 40, 44)]


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("case,n,f,ncols", FULL_EDGES)
@pytest.mark.parametrize("variant,B", EDGE_CASES)
def test_onehot_full_edges_match_plain(dev, variant, B, case, n, f, ncols,
                                       layout):
    rng = np.random.default_rng(n + B)
    bins = torch.as_tensor(_edge_bins(rng, case, n, ncols)).to(dev)
    g, h, m = _rows(rng, n, dev)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, f_limit=f,
                                    method="onehot", variant=variant,
                                    layout=layout)
    got = thist.build_histogram(bins, g, h, m, B, f_limit=f, method="onehot",
                                variant=variant, layout=layout)
    again = thist.build_histogram(bins, g, h, m, B, f_limit=f,
                                  method="onehot", variant=variant,
                                  layout=layout)
    torch.cuda.synchronize()
    assert got.shape == (f, B, 3)
    assert relerr(got, ref) <= TOL
    assert torch.equal(got, again)


# (case, f, nc): a row width that is not a multiple of 16; a block with a
# NaN gradient; rows wider than the kernels stage as they lie; a matrix
# that does not start 16-byte aligned; more features a CTA than the
# transpose has words a thread (packed at B = 16 and 8)
LEAVES_EDGES = [("ld19", 11, 19), ("nan_block", 11, 19), ("wide", 7, 300),
                ("unaligned", 11, 19), ("many_features", 40, 44)]


@pytest.mark.parametrize("case,f,nc", LEAVES_EDGES)
@pytest.mark.parametrize("variant,B", EDGE_CASES)
def test_onehot_leaves_edges_match_plain(dev, variant, B, case, f, nc):
    rng = np.random.default_rng(nc + B)
    k, BR = 5, 256
    block_leaf = np.array([3, 0, 3, 1, 4, 0, 2], np.int32)
    C = block_leaf.size * BR
    raw = rng.integers(0, 256, (C + 1, nc)).astype(np.uint8)
    comb = torch.as_tensor(raw).to(dev)
    comb = comb[1:] if case == "unaligned" else comb[:C]
    assert comb.is_contiguous()
    g, h, m = _rows(rng, C, dev)
    nan_slot = None
    if case == "nan_block":
        g[4 * BR + 9] = float("nan")
        nan_slot = int(block_leaf[4])
    bl = torch.as_tensor(block_leaf).to(dev)
    kw = dict(block_rows=BR, f_limit=f, method="onehot", variant=variant)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert got.shape == (k, f, B, 3)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    if nan_slot is not None:
        assert bool(torch.isnan(got[nan_slot][..., 0]).all())
        others = [s for s in range(k) if s != nan_slot]
        assert bool(torch.isfinite(got[others]).all())
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL
    assert torch.equal(got[fin], again[fin])


def _split_units(units, nlb, resident):
    """(units a CTA, grid x): the launchers' row split
    (onehot_common.cuh::split_units)."""
    splits = min(max(1, resident // max(nlb, 1)), units)
    per = -(-units // splits)
    return per, -(-units // per)


def _is_prime(p):
    return p > 1 and all(p % d for d in range(2, int(p ** 0.5) + 1))


@pytest.mark.parametrize("layout,B", [("featmajor", 256), ("rowmajor", 256),
                                      ("featmajor", 1025),
                                      ("featmajor", 1200)])
def test_onehot_full_int8_mid_block_matches_plain(dev, layout, B):
    """A CTA whose chunk range starts and ends inside a quantization block
    (the full kernel splits rows in chunks, not blocks): the int32 sums
    fold by the block of each chunk -- at u8 in the dense design, and at
    u16 in the bucketed one over blocks of 384 rows (B = 1,025 and 1,200,
    feature-major), whose segments then start mid-block and span two
    blocks; there bit for bit the plain version.  The row count
    is the first prime number of chunks (with a ragged last one) for
    which the launcher's split puts both ends of some CTA's range inside
    a block."""
    f = 28 if B <= 256 else 5
    plan = thist.onehot_plan("int8", f, B)
    if plan["design"] == "dense":
        nlb = -(-ov.total_lanes("int8", f, B) // 512)
    else:
        nlb = f * plan["gpf"]
    per_sm = thist.onehot_kernel_attributes("onehot_full", "int8", f, B,
                                            layout, ld=f)["ctas_per_sm"]
    resident = per_sm * torch.cuda.get_device_properties(
        dev).multi_processor_count
    found = None
    for chunks in filter(_is_prime, range(2003, 4000)):
        n = chunks * 128 - 57
        cpb = ov.pallas_block_rows("int8", layout, n, f, B) // 128
        per, gx = _split_units(chunks, nlb, resident)
        mid = [x for x in range(gx - 1)
               if (x * per) % cpb and ((x + 1) * per) % cpb]
        if mid:
            found = n
            break
    assert found is not None
    rng = np.random.default_rng(found)
    dtype = np.uint8 if B <= 256 else np.uint16
    bins = torch.as_tensor(rng.integers(0, min(B, 256) if B <= 256 else B,
                                        (found, f)).astype(dtype)).to(dev)
    g, h, m = _rows(rng, found, dev)
    kw = dict(method="onehot", variant="int8", layout=layout)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, **kw)
    got = thist.build_histogram(bins, g, h, m, B, **kw)
    again = thist.build_histogram(bins, g, h, m, B, **kw)
    torch.cuda.synchronize()
    assert relerr(got, ref) <= TOL
    assert torch.equal(got, again)
    if B > 256:
        _int8_bits(got, ref)


def test_onehot_kernel_attributes(dev):
    """The attribute query reports each body's kernel: registers, and the
    dynamic shared memory of a launch at the width asked for -- more for
    more features a CTA, more for wider row-major rows, the same whether
    or not a launch came first."""
    for v in ("base", "staged", "packed", "int8"):
        for kernel, layout in (("onehot_full", "featmajor"),
                               ("onehot_full", "rowmajor"),
                               ("onehot_leaves", "rowmajor")):
            a = thist.onehot_kernel_attributes(kernel, v, 28, 64, layout,
                                               ld=40)
            assert 0 < a["registers"] <= 255
            assert a["dynamic_smem_bytes"] > 0
            assert a["ctas_per_sm"] >= 1
            one = thist.onehot_kernel_attributes(kernel, v, 1, 64, layout)
            assert one["dynamic_smem_bytes"] < a["dynamic_smem_bytes"]
    wide = thist.onehot_kernel_attributes("onehot_leaves", "base", 28, 64,
                                          ld=200)
    narrow = thist.onehot_kernel_attributes("onehot_leaves", "base", 28, 64,
                                            ld=40)
    assert wide["dynamic_smem_bytes"] > narrow["dynamic_smem_bytes"]


def test_onehot_wrappers_check_their_inputs(dev):
    bins = torch.zeros(1024, 4, dtype=torch.uint8, device=dev)
    z = torch.zeros(1024, device=dev)
    with pytest.raises(ValueError, match="does not support"):
        thist.hist_onehot_full(bins, z, z, z, 255, variant="packed")
    with pytest.raises(ValueError, match="layout"):
        thist.hist_onehot_full(bins, z, z, z, 64, layout="colmajor")
    with pytest.raises(ValueError, match="multiple"):
        thist.hist_onehot_leaves(bins, z, z, z,
                                 torch.zeros(16, dtype=torch.int32,
                                             device=dev), 2, 16,
                                 block_rows=64)
    with pytest.raises(ValueError, match="mask must be"):
        thist.quantize_int8(z, z, z[:1000], 512)
    with pytest.raises(ValueError, match="hess must be"):
        thist.quantize_int8(z, z.double(), z, 512)
    with pytest.raises(ValueError, match="block_rows"):
        thist.quantize_int8(z, z, z, 200)
    with pytest.raises(ValueError, match="block_rows"):
        thist.quantize_int8(z, z, z, 16384 + 128)


@pytest.mark.parametrize("variant,max_bin", [("staged", 255),
                                             ("packed", 63), ("int8", 255),
                                             ("auto", 255)])
def test_training_force_row_wise_launches_only_onehot(dev, variant,
                                                      max_bin):
    """force_row_wise runs every histogram through the one-hot kernels (and
    int8 through the quantize kernel) and grows the trees of the same run
    under force_plain() on the card; auto trains with the elected
    variant."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(1)
    X = rng.normal(size=(20_000, 10)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=20_000)
         > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "force_row_wise": True, "hist_variant": variant,
              "max_bin": max_bin}
    if variant == "auto":                      # elect outside the count
        elected = ov.pick_variant(256, 10, device=dev)
    thist.reset_launch_counts()
    bk = lgt.train(params, lgt.Dataset(X, label=y), 5, verbose_eval=False,
                   device="cuda")
    used = bk._gbdt._grower_cfg.hist_variant
    assert used == (elected if variant == "auto" else variant)
    assert (thist.launch_counts["onehot_quant"] > 0) == (used == "int8")
    assert thist.launch_counts["onehot_full"] == 5
    assert thist.launch_counts["onehot_leaves"] >= 5
    assert thist.launch_counts["hist_full"] == 0
    assert thist.launch_counts["hist_leaves"] == 0
    thist.reset_launch_counts()
    with thist.force_plain():
        bp = lgt.train(params, lgt.Dataset(X, label=y), 5,
                       verbose_eval=False, device="cuda")
    assert not any(thist.launch_counts.values())
    for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
        assert np.array_equal(tk.split_feature, tp.split_feature)
        assert np.array_equal(tk.threshold, tp.threshold)
    np.testing.assert_allclose(bk.predict(X[:2000]), bp.predict(X[:2000]),
                               rtol=0, atol=1e-6)


def _hold_quant(got, ref, n):
    """q equal (and zero from n to its row stride, a multiple of 128, which
    the int8 one-hot kernels read as whole chunks), NaN scales in the same
    places and every other scale with the same bits."""
    (q, s), (qp, sp) = got, ref
    assert torch.equal(q, qp)
    ldq = -(-n // 128) * 128
    assert q.stride() == (ldq, 1)
    assert not q.as_strided((9, ldq), (ldq, 1))[:, n:].any()
    assert torch.equal(torch.isnan(s), torch.isnan(sp))
    ok = ~torch.isnan(sp)
    assert torch.equal(s[ok].view(torch.int32), sp[ok].view(torch.int32))


def test_quantize_kernel_is_bit_identical_to_plain(dev):
    """Both input forms of the quantize kernel: prepped rows [3, N] (the
    shootout shell's) and grad, hess and mask, whose products it forms
    itself (the int8 wrappers'), one launch each."""
    rng = np.random.default_rng(3)
    mrng = np.random.default_rng(4)
    for n, br in ((1_000_003, 1024), (262_144, 512), (5_000, 128),
                  (70_000, 16384)):
        x = (rng.normal(size=(3, n)) * rng.lognormal(0, 3, (3, n))).astype(
            np.float32)
        x[:, br:2 * br] = 0.0                            # an all-zero block
        x[:, 2 * br:3 * br] = rng.integers(-120, 120, (3, br)) + 0.5
        x[:, 2 * br] = 127.0                             # ties at s = 1
        x[0, 3 * br + 5] = np.nan
        x[1, 4 * br - 1] = np.inf
        rows = torch.as_tensor(x).to(dev)
        before = thist.launch_counts["onehot_quant"]
        got = thist.quantize_int8_blocks(rows, br)
        torch.cuda.synchronize()
        assert thist.launch_counts["onehot_quant"] == before + 1
        _hold_quant(got, ov.quantize_int8_blocks_plain(rows, br), n)
        # grad, hess and mask: weights 0, 1 and 2.5, the special blocks
        # under weight 1, a NaN gradient under weight 0 (NaN·0 is NaN);
        # at 5,000 rows grad starts 4 bytes past a 16-byte boundary
        m = np.where(mrng.random(n) < 0.2, 0.0,
                     np.where(mrng.random(n) < 0.3, 2.5, 1.0)).astype(
                         np.float32)
        m[br:5 * br] = 1.0
        m[3 * br + 11] = 0.0
        x[0, 3 * br + 11] = np.nan
        off = int(n == 5_000)
        g = torch.as_tensor(np.concatenate([np.zeros(off, np.float32),
                                            x[0]])).to(dev)[off:]
        h, mt = (torch.as_tensor(a).to(dev) for a in (x[1], m))
        before = thist.launch_counts["onehot_quant"]
        got = thist.quantize_int8(g, h, mt, br)
        torch.cuda.synchronize()
        assert thist.launch_counts["onehot_quant"] == before + 1
        _hold_quant(got, ov.quantize_int8_blocks_plain(
            ov.prep_f32(g, h, mt), br), n)


def _frontier_inputs(rng, dev, C, f, BR, nb_short):
    """One round's gathered rows as ``frontier.py`` makes them: the float32
    (g, h, m) bytes after the bins in ``comb [C, f + 12]``, grad and hess
    copied out of it, the mask zeroed past each block's rows (here the
    last ``nb_short`` rows of the blocks, as a short slot leaves them)."""
    comb = rng.integers(0, 256, (C, f + 12)).astype(np.uint8)
    gh = np.stack([rng.normal(size=C), rng.uniform(0.05, 0.25, C),
                   np.where(rng.random(C) < 0.2, 0.0, 1.0)], 1)
    comb[:, f:] = gh.astype(np.float32).view(np.uint8).reshape(C, 12)
    combb = torch.as_tensor(comb).to(dev)
    ghb = combb[:, f:].contiguous().view(torch.float32)        # [C, 3]
    okrow = torch.arange(C, device=dev) % BR < BR - nb_short
    m = torch.where(okrow, ghb[:, 2], 0.0)
    return combb, ghb[:, 0].contiguous(), ghb[:, 1].contiguous(), m


def test_quantize_kernel_takes_the_frontier_inputs(dev):
    rng = np.random.default_rng(12)
    C, f, BR = 8 * 512, 28, 512
    comb, g, h, m = _frontier_inputs(rng, dev, C, f, BR, 100)
    g[3 * BR + 40] = float("nan")                 # under a zero mask
    m[3 * BR + 40] = 0.0
    got = thist.quantize_int8(g, h, m, BR)
    torch.cuda.synchronize()
    _hold_quant(got, ov.quantize_int8_blocks_plain(ov.prep_f32(g, h, m),
                                                   BR), C)
    nan = torch.isnan(got[1])
    assert bool(nan[3, [0, 3, 6]].all()) and int(nan.sum()) == 3


@pytest.mark.parametrize("br", [384, 4224, 8320])
def test_quantize_kernel_odd_blocks_match_plain(dev, br):
    """Blocks whose rows a thread cannot split into whole warps (threads
    past the block's rows own none), and a 96-thread block alone in its
    CTA; a ragged last block."""
    rng = np.random.default_rng(br)
    n = 3 * br + 77
    g, h, m = _rows(rng, n, dev)
    g[br + 5] = float("nan")
    got = thist.quantize_int8(g, h, m, br)
    torch.cuda.synchronize()
    _hold_quant(got, ov.quantize_int8_blocks_plain(ov.prep_f32(g, h, m),
                                                   br), n)


@pytest.mark.parametrize("entry", ["full", "leaves"])
def test_int8_call_launches_one_quantize_and_no_prep(dev, entry):
    """An int8 histogram call runs its pre-pass as one launch of the
    quantize kernel: none of prep_f32's products or its stack."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(13)
    C, f, BR, k, B = 8 * 512, 28, 512, 3, 256
    comb, g, h, m = _frontier_inputs(rng, dev, C, f, BR, 100)
    bl = torch.as_tensor(np.array([0, 2, 1, 0, 2, 2, 1, 0], np.int32)).to(dev)
    if entry == "full":
        call = lambda: thist.build_histogram(  # noqa: E731
            comb, g, h, m, B, f_limit=f, method="onehot", variant="int8")
    else:
        call = lambda: thist.build_histogram_leaves(  # noqa: E731
            comb, g, h, m, bl, k, B, block_rows=BR, f_limit=f,
            method="onehot", variant="int8")

    def kernels(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.key for e in prof.key_averages()
                for _ in range(e.count) if e.device_type != DeviceType.CPU]

    prep = set(kernels(lambda: ov.prep_f32(g, h, m)))
    assert prep                                 # two products and a stack
    before = dict(thist.launch_counts)
    names = kernels(call)
    assert sum("quant_kernel" in x for x in names) == 1, names
    assert not prep & set(names), names
    assert thist.launch_counts["onehot_quant"] == before["onehot_quant"] + 2
    assert thist.launch_counts[f"onehot_{entry}"] == (
        before[f"onehot_{entry}"] + 2)


def test_quantize_kernel_attributes(dev):
    """No spill at the main path's blocks, 4 rows a thread; blocks below
    512 rows share a CTA of 128 threads."""
    for br, rows, tpb, blocks in ((1024, 4, 256, 1), (512, 4, 128, 1),
                                  (128, 4, 32, 4), (256, 4, 64, 2),
                                  (4224, 8, 544, 1), (16384, 16, 1024, 1)):
        a = thist.quant_kernel_attributes(br)
        assert (a["rows_per_thread"], a["threads_per_block"],
                a["blocks_per_cta"]) == (rows, tpb, blocks)
        assert 0 < a["registers"] <= 64
        if br in (512, 1024):
            assert a["local_bytes"] == 0


BENCH_CASES = [(v, B) for B in (64, 256) for v in ov.AUTO_CANDIDATES
               if ov.VARIANTS[v].supports(B)]


@pytest.mark.parametrize("variant,B", BENCH_CASES)
def test_bench_kernel_matches_plain(dev, variant, B):
    """K4: the shootout shell's entry on caller-transposed bins, as given."""
    rng = np.random.default_rng(9)
    n, f, BR = 65_536, 28, 1024
    bins_t = torch.as_tensor(rng.integers(0, B, (f, n)).astype(np.uint8)
                             ).to(dev)
    g, h, m = _rows(rng, n, dev)
    prep, run = ov.make_bench_kernel(variant, f, B, BR)
    rows = prep(g, h, m)
    with thist.force_plain():
        ref = run(bins_t, rows)
    before = dict(thist.launch_counts)
    got = run(bins_t, rows)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_bench"] == before["onehot_bench"] + 1
    assert thist.launch_counts["onehot_full"] == before["onehot_full"]
    assert (thist.launch_counts["onehot_quant"]
            == before["onehot_quant"] + (variant == "int8"))
    assert got.shape == (f, B, 3)
    assert relerr(got, ref) <= TOL


def test_election_on_the_card_passes_parity_everywhere(dev):
    """Every candidate the width serves is timed and passes parity; the
    second call is served from the cache without timing again."""
    for B in (256, 64):
        ov._AUTO_CACHE.pop((torch.cuda.get_device_name(dev), B), None)
        won = ov.pick_variant(B, 28, device=dev)
        res = ov.AUTO_RESULTS[(torch.cuda.get_device_name(dev), B)]
        assert set(res) == {v for v in ov.AUTO_CANDIDATES
                            if ov.VARIANTS[v].supports(B)}
        assert all(r["qualified"] for r in res.values()), res
        assert won == min(res, key=lambda v: res[v]["ms"])
        before = dict(thist.launch_counts)
        assert ov.pick_variant(B, 28, device=dev) == won
        assert thist.launch_counts == before


# --------------------------------------------------------------------------
# the training knobs' inputs: counter-based draws, compacted bags, GOSS
# --------------------------------------------------------------------------

def test_rng_on_the_card_equals_the_cpu(dev):
    """The threefry draws are integer ops: bit-identical on the card."""
    from lightgbm_tpu_torch.ops import grower as tgrow
    from lightgbm_tpu_torch.utils import random_gen as trng
    for seed, it, salt, n in ((3, 0, 0, 1_000_000), (42, 7, 1, 70_001)):
        key = trng.key_for_iteration(seed, it, salt)
        cpu = trng.uniform(key, n)
        card = trng.uniform(key.to(dev), n)
        assert torch.equal(card.cpu(), cpu)
    key = trng.key_for_iteration(9, 4, 2)
    steps = torch.arange(0, 64, 3)
    fmask = torch.ones(28)
    fmask[[2, 5, 11]] = 0.0
    cpu = tgrow.node_feature_mask_for(key, steps, fmask, 0.8)
    card = tgrow.node_feature_mask_for(key.to(dev), steps.to(dev),
                                       fmask.to(dev), 0.8)
    assert torch.equal(card.cpu(), cpu)
    nb = torch.randint(2, 257, (28,), dtype=torch.int32)
    nan = torch.where(torch.arange(28) % 4 == 0, nb - 1, -1)
    cpu = tgrow.rand_thresholds_for(key, steps, 6, nb, nan)
    card = tgrow.rand_thresholds_for(key.to(dev), steps.to(dev), 6,
                                     nb.to(dev), nan.to(dev))
    assert torch.equal(card.cpu(), cpu)


def _compacted(mask, cap):
    """The booster's compaction: in-bag rows, then row n - 1 at weight 0."""
    n = mask.shape[0]
    cs = torch.cumsum((mask > 0).to(torch.int64), 0)
    t = torch.arange(1, cap + 1, device=mask.device)
    rows = torch.clamp(torch.searchsorted(cs, t, right=False), max=n - 1)
    rw = torch.where(t <= cs[-1], mask[rows], torch.zeros_like(mask[:1]))
    return rows, rw


def test_compacted_bag_histogram_matches_plain(dev):
    """A compacted bag of cap rows whose padding repeats row n - 1 with
    weight 0 (grad and hess not zero there): the kernel's histogram equals
    the plain one, and the padding adds nothing."""
    rng = np.random.default_rng(11)
    n, f, B = 200_000, 28, 256
    bins = torch.as_tensor(rng.integers(0, 255, (n, f)).astype(np.uint8)
                           ).to(dev)
    g, h, _ = _rows(rng, n, dev)
    mask = torch.as_tensor((rng.random(n) < 0.5).astype(np.float32)).to(dev)
    cap = 101_376
    rows, rw = _compacted(mask, cap)
    assert int((rw == 0).sum()) > 0 and int(rows[-1]) == n - 1
    args = (bins[rows], g[rows] * mask[rows], h[rows] * mask[rows], rw, B)
    with thist.force_plain():
        ref = thist.build_histogram(*args)
    got = thist.build_histogram(*args)
    torch.cuda.synchronize()
    assert relerr(got, ref) <= ATOMIC_TOL
    k = int(mask.sum())
    with thist.force_plain():
        bag_only = thist.build_histogram(bins[rows[:k]], args[1][:k],
                                         args[2][:k], rw[:k], B)
    assert relerr(got, bag_only) <= ATOMIC_TOL


def test_goss_top_k_on_the_card_equals_the_cpu(dev):
    """GOSS's top rows come from a stable descending sort: with the ties of
    an early iteration the card picks the lower index first, as the CPU
    (and lax.top_k) does."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.goss import goss_mask_from_importance
    from lightgbm_tpu_torch.utils import random_gen as trng
    rng = np.random.default_rng(5)
    n = 1_000_000
    imp = rng.choice(np.float32([0.0625, 0.05, 0.125]), n).astype(np.float32)
    imp[::7] = rng.random(n)[::7].astype(np.float32)
    cfg = Config.from_params({"boosting": "goss"})
    u = trng.uniform(trng.key_for_iteration(cfg.bagging_seed, 0), n)
    k_top = int(cfg.top_rate * n)
    m_cpu, a_cpu = goss_mask_from_importance(cfg, torch.as_tensor(imp), u,
                                             k_top)
    m_card, a_card = goss_mask_from_importance(
        cfg, torch.as_tensor(imp).to(dev), u.to(dev), k_top)
    assert torch.equal(m_card.cpu(), m_cpu)
    assert torch.equal(a_card.cpu(), a_cpu)


# ---------------------------------------------------------------------------
# u16 bins: the atomic kernels' uint16 instantiations
# ---------------------------------------------------------------------------

def _u16(rng, shape, hi, dev):
    """u16 bins in [0, hi), a tenth of them raised to >= 40,000 (above any
    B: dropped), as a CUDA uint16 tensor."""
    b = rng.integers(0, hi, shape).astype(np.uint16)
    high = rng.random(shape) < 0.1
    b[high] = rng.integers(40_000, 65_536, int(high.sum()))
    return torch.as_tensor(b).to(dev)


# (n, f, ncols, B): B = 1,024 (max_bin=1023) at the main path's feature
# count, the widest EFB bundle (B = 4,096: one feature a CTA) and a
# bundle width at which a CTA holds two features (B = 3,072); rows of an
# odd stride (2 * ncols bytes: rows 2-byte, not 16-byte, aligned)
FULL_U16 = [(100_003, 28, 28, 1024), (30_001, 5, 7, 4096),
            (30_001, 5, 5, 3072), (20_011, 13, 19, 1024)]


@pytest.mark.parametrize("n,f,ncols,B", FULL_U16)
def test_hist_full_u16_matches_plain(dev, n, f, ncols, B):
    rng = np.random.default_rng(n + B)
    bins = _u16(rng, (n, ncols), B + 100, dev)      # bins >= B present
    g, h, m = _rows(rng, n, dev)
    g[7] = float("nan")
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    before = thist.launch_counts["hist_full"]
    got = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    again = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_full"] == before + 2
    assert got.shape == (f, B, 3)
    _hold_atomic(got, again, ref)


# (k, BR, nb, f, nc, B): the frontier's comb of u16 bins and 6 gh columns
# (nc = f + 6) at B = 1,024 and 4,096, and an odd nc
LEAVES_U16 = [(16, 512, 64, 28, 34, 1024), (16, 512, 40, 5, 11, 4096),
              (8, 256, 50, 13, 19, 1024)]


@pytest.mark.parametrize("k,BR,nb,f,nc,B", LEAVES_U16)
def test_hist_leaves_u16_matches_plain(dev, k, BR, nb, f, nc, B):
    rng = np.random.default_rng(nb * k + B)
    C = nb * BR
    comb = _u16(rng, (C, nc), B + 100, dev)
    g, h, m = _rows(rng, C, dev)
    bl = torch.as_tensor(_leaf_map(rng, "random", nb, k)).to(dev)
    kw = dict(block_rows=BR, f_limit=f)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert got.shape == (k, f, B, 3)
    _hold_atomic(got, again, ref)


@pytest.mark.parametrize("kernel", ("hist_full", "hist_leaves"))
def test_atomic_plan_narrows_groups_at_bundle_widths(dev, kernel):
    """Wide bin ranges take narrow groups in the dealt design, not a
    refusal: two features a CTA at B = 4,096 (a feature's histogram is 96
    KB) and at B = 3,072, with tiles of at least 128 rows and no spill;
    the owned design would hold one feature at B = 4,096 (its lane words
    take 16 KB more)."""
    for B, fg in ((4096, 2), (3072, 2)):
        plan = thist.atomic_plan(kernel, dev, 66, 60, B, esz=2)
        assert plan["design"] == 1 and plan["fg"] == fg
        assert plan["tile"] >= 128 and plan["local_bytes"] == 0
        assert plan["dynamic_smem_bytes"] <= thist.SMEM_MAX_BYTES
    with thist.atomic_design("owned"):
        plan = thist.atomic_plan(kernel, dev, 66, 60, 4096, esz=2)
    assert plan["design"] == 0 and plan["fg"] == 1


@pytest.mark.parametrize("kernel,stride", (("hist_full", 35),
                                           ("hist_leaves", 41)))
def test_atomic_plan_deals_warps_at_the_bundle_width(dev, kernel, stride):
    """At the sparse_efb bundle width (35 bundle columns, B = 2,599; the
    leaves' rows carry 6 u16 gh columns more) a CTA holds 3 features: the
    owned design would run 3 warps an SM, the dealt design runs 24, 22 of
    them adding rows and 2 staging, with no spill."""
    plan = thist.atomic_plan(kernel, dev, stride, 35, 2599, esz=2)
    assert plan["design"] == 1 and plan["fg"] == 3
    assert plan["threads"] == 768 and plan["ctas_per_sm"] == 1
    warps = plan["threads"] // 32 * plan["ctas_per_sm"]
    assert warps >= 16 and warps - plan["stagers"] >= 16
    assert plan["local_bytes"] == 0
    with thist.atomic_design("owned"):
        owned = thist.atomic_plan(kernel, dev, stride, 35, 2599, esz=2)
    assert owned["threads"] // 32 * owned["ctas_per_sm"] <= 3


def _crafted_u16(B, rows=2048):
    """Columns whose 32-row steps are the grouping's edge cases: 31 lanes
    in one bin and one in another; 16 and 16; 32 distinct bins; every bin
    >= B (dropped); one bin a step, changing from step to step."""
    r = np.arange(rows)
    return np.stack([np.where(r % 32 == 5, 7, 3),
                     np.where(r % 2 == 0, B - 1, 17),
                     (r * 37) % B,
                     B + r % 500,
                     (r // 32) % 3], 1).astype(np.uint16)


@pytest.mark.parametrize("design", thist.ATOMIC_DESIGNS)
@pytest.mark.parametrize("B", (1024, 2599, 4096))
@pytest.mark.parametrize("kernel", ("hist_full", "hist_leaves"))
def test_atomic_u16_crafted_steps_match_plain(dev, kernel, B, design):
    """Both designs at u16 widths on crafted steps, a NaN row among them:
    within one rounding step of the plain version, the NaN in its own
    entries, the same bits twice."""
    rng = np.random.default_rng(B)
    bins = _crafted_u16(B)
    n, f = bins.shape
    g, h, m = _rows(rng, n, dev)
    g[77] = float("nan")
    with thist.atomic_design(design):
        if kernel == "hist_full":
            def call():
                return thist.build_histogram(torch.as_tensor(bins).to(dev),
                                             g, h, m, B)
        else:
            gh = rng.integers(0, 65_536, (n, 6)).astype(np.uint16)
            comb = torch.as_tensor(np.concatenate([bins, gh], 1)).to(dev)
            bl = torch.tensor([0, 1, 0, 2], dtype=torch.int32, device=dev)

            def call():
                return thist.build_histogram_leaves(comb, g, h, m, bl, 3, B,
                                                    block_rows=512, f_limit=f)
        with thist.force_plain():
            ref = call()
        before = thist.launch_counts[kernel]
        got, again = call(), call()
        torch.cuda.synchronize()
        plan = next(p for key, p in thist._plans.items()
                    if key[0] == kernel and key[-1] == _design_id(design))
    assert thist.launch_counts[kernel] == before + 2
    assert plan["design"] == _design_id(design)
    _hold_atomic(got, again, ref)
    assert 0 < int(torch.isnan(got).sum()) <= 3 * f


def _design_id(design):
    return thist.ATOMIC_DESIGNS.index(design)


def test_training_u16_and_efb_match_plain(dev):
    """max_bin=1023 (u16 bins) and an EFB bundle matrix of u16 columns:
    the trees grown through the kernels are those grown under
    force_plain()."""
    import scipy.sparse as sp
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(3)
    n = 30_000
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.5).astype(np.float32)
    cats = rng.integers(0, 400, n)                   # a 400-level one-hot
    Xs = sp.hstack([sp.csr_matrix((np.ones(n), (np.arange(n), cats)),
                                  shape=(n, 400)), sp.csr_matrix(X)]).tocsr()
    ys = ((cats % 7 < 3) ^ (X[:, 0] > 0)).astype(np.float32)
    for data, label, params in (
            (X, y, {"max_bin": 1023}), (Xs, ys, {})):
        params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
                  **params}
        ds = lgt.Dataset(data, label=label, params=params).construct(dev)
        assert ds._inner.bins.dtype == np.uint16
        thist.reset_launch_counts()
        bk = lgt.train(params, ds, 3, verbose_eval=False, device="cuda")
        assert thist.launch_counts["hist_full"] == 3
        with thist.force_plain():
            bp = lgt.train(params, ds, 3, verbose_eval=False, device="cuda")
        for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
            assert np.array_equal(tk.split_feature, tp.split_feature)
            assert np.array_equal(tk.threshold, tp.threshold)


# ---------------------------------------------------------------------------
# wide u16 widths: bin tiles (a feature's bins split over CTAs)
# ---------------------------------------------------------------------------

def _wide_u16(rng, shape, B, kind, dev):
    """u16 bins for a width B above one feature's CTA: uniform over [0,
    65,536) (bins >= B dropped) or Zipf-skewed over [0, B) (a few bins
    hold most rows, so most steps of a bin tile hold no row of it); every
    column holds bin 65,535 and bin B - 1."""
    if kind == "zipf":
        p = 1.0 / np.arange(1, B + 1) ** 1.1
        b = rng.choice(B, size=shape, p=p / p.sum()).astype(np.uint16)
    else:
        b = rng.integers(0, 65_536, shape).astype(np.uint16)
    b[3], b[11] = 65_535, B - 1
    return torch.as_tensor(b).to(dev)


def _hold_bits(got, again, ref):
    """Bit for bit the plain version's result, and the same bits twice."""
    assert _same_bits(got, ref)
    assert _same_bits(got, again)


# (B, kind): widths of two, two and eight bin tiles a feature, with
# uniform and Zipf-skewed bins
WIDE_U16 = [(B, kind) for B in (12_000, 16_384, 65_536)
            for kind in ("random", "zipf")]


@pytest.mark.parametrize("B,kind", WIDE_U16)
def test_hist_full_wide_bins_match_plain_bit_for_bit(dev, B, kind):
    """K1 above 9,685 bins: each feature's bins in bin tiles, each CTA
    adding only its tile's rows, bit for bit the plain version and the
    same bits twice; the plan's tiles are the geometry's."""
    rng = np.random.default_rng(B)
    n, f, ncols = 100_003, 5, 7
    bins = _wide_u16(rng, (n, ncols), B, kind, dev)
    g, h, m = _rows(rng, n, dev)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    before = thist.launch_counts["hist_full"]
    got = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    again = thist.build_histogram(bins, g, h, m, B, f_limit=f)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_full"] == before + 2
    assert got.shape == (f, B, 3)
    _hold_bits(got, again, ref)
    plan = thist.atomic_plan("hist_full", dev, ncols, f, B, esz=2)
    geo = thist.atomic_geometry(f, B, ncols, 2)
    assert plan["tiles"] > 1
    for key in ("design", "fg", "tile", "tiles", "tile_bins"):
        assert plan[key] == geo[key], key


@pytest.mark.parametrize("B,kind", WIDE_U16)
def test_hist_leaves_wide_bins_match_plain_bit_for_bit(dev, B, kind):
    """K2 above 9,685 bins: the frontier's comb (5 features + 6 u16 gh
    columns), random slots with two never named, bit for bit the plain
    version and the same bits twice."""
    rng = np.random.default_rng(B + 1)
    k, BR, nb, f = 8, 512, 40, 5
    C = nb * BR
    comb = torch.cat([_wide_u16(rng, (C, f), B, kind, dev),
                      torch.as_tensor(rng.integers(0, 65_536, (C, 6))
                                      .astype(np.uint16)).to(dev)], 1)
    g, h, m = _rows(rng, C, dev)
    bl = torch.as_tensor(_leaf_map(rng, "random", nb, k)).to(dev)
    kw = dict(block_rows=BR, f_limit=f)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert got.shape == (k, f, B, 3)
    _hold_bits(got, again, ref)
    assert thist.atomic_plan("hist_leaves", dev, f + 6, f, B,
                             esz=2)["tiles"] > 1


@pytest.mark.parametrize("design", ("owned", "dealt"))
@pytest.mark.parametrize("kernel", ("hist_full", "hist_leaves"))
def test_atomic_forced_tiles_match_the_untiled_kernel(dev, kernel, design):
    """Bin tiles forced at B = 1,024, where one feature fits a CTA (the
    listed design asked for by ``atomic_design``, its tiles of 256 bins):
    the same bits as the untiled kernel in each design, which itself
    equals the plain version bit for bit; the crafted steps' edge cases
    (one bin a step, bins >= B, a NaN row) included."""
    B = 1024
    rng = np.random.default_rng(2)
    bins = np.concatenate([_crafted_u16(B, rows=4096),
                           rng.integers(0, B + 50, (4096, 3))
                           .astype(np.uint16)], 1)
    n, f = bins.shape
    g, h, m = _rows(rng, n, dev)
    g[77] = float("nan")
    if kernel == "hist_full":
        x = torch.as_tensor(bins).to(dev)

        def call():
            return thist.build_histogram(x, g, h, m, B)
    else:
        gh = rng.integers(0, 65_536, (n, 6)).astype(np.uint16)
        comb = torch.as_tensor(np.concatenate([bins, gh], 1)).to(dev)
        bl = torch.tensor([0, 1, 0, 2, 2, 1, 0, 3], dtype=torch.int32,
                          device=dev)

        def call():
            return thist.build_histogram_leaves(comb, g, h, m, bl, 4, B,
                                                block_rows=512, f_limit=f)
    with thist.force_plain():
        ref = call()
    with thist.atomic_design(design):
        untiled = call()
    with thist.atomic_design("listed"):
        got, again = call(), call()
        stride = f if kernel == "hist_full" else f + 6
        plan = thist.atomic_plan(kernel, dev, stride, f, B, esz=2)
    torch.cuda.synchronize()
    geo = thist.atomic_geometry(f, B, stride, 2, "listed")
    # the listed design's tiles of 256 bins (4 at B = 1,024)
    assert plan["tiles"] == 4
    assert plan["design"] == _design_id("listed")
    for key in ("design", "tiles", "tile_bins"):
        assert plan[key] == geo[key], key
    _hold_atomic(untiled, untiled, ref)
    fin = torch.isfinite(ref)
    assert _same_bits(untiled[fin], ref[fin])
    assert _same_bits(got, untiled) and _same_bits(got, again)


def test_atomic_plan_tiles_every_u16_width(dev):
    """The plan at the main path's shape (28 features, the frontier's comb
    of 34 columns): untiled to B = 8,192, in bin tiles above (the listed
    design: 256 of 256 bins at B = 65,536), every tile within the shared
    memory a CTA may hold and no spill; a width no u16 bin reaches is
    refused."""
    for B in (1024, 8192, 9686, 20_000, 65_536):
        for kernel, stride in (("hist_full", 28), ("hist_leaves", 34)):
            plan = thist.atomic_plan(kernel, dev, stride, 28, B, esz=2)
            assert (plan["tiles"] > 1) == (B > 8192), (B, plan)
            assert plan["tiles"] * plan["tile_bins"] >= B
            assert (plan["tiles"] - 1) * plan["tile_bins"] < B
            assert plan["dynamic_smem_bytes"] <= thist.SMEM_MAX_BYTES
            assert plan["local_bytes"] == 0
            assert (plan["design"] == 2) == (B > 8192)
    assert plan["tiles"] == 256 and plan["tile_bins"] == 256
    with pytest.raises(ValueError, match="max_bin=70000"):
        thist.atomic_plan("hist_full", dev, 28, 28, 70_000, esz=2)


# (B, case): the listed design's inputs at every bin-tiled width: uniform
# bins (bins >= B present), Zipf-skewed, every row in one tile (one
# segment a feature, split into units chained through its partial), every
# row at a bin >= B (every segment empty; below 65,536, which no u16 bin
# reaches), and uniform bins with a NaN row
LISTED_CASES = [(B, case) for B in (12_000, 16_384, 65_536)
                for case in ("random", "zipf", "one_tile", "all_high", "nan")
                if (B, case) != (65_536, "all_high")]


def _listed_bins(rng, case, shape, B, dev):
    if case in ("random", "zipf", "nan"):
        return _wide_u16(rng, shape, B, "zipf" if case == "zipf"
                         else "random", dev)
    lo, hi = (B // 2, B // 2 + 200) if case == "one_tile" else (B, 65_536)
    return torch.as_tensor(rng.integers(lo, hi, shape).astype(np.uint16)
                           ).to(dev)


@pytest.mark.parametrize("B,case", LISTED_CASES)
@pytest.mark.parametrize("kernel", ("hist_full", "hist_leaves"))
def test_bin_tiled_kernels_match_plain(dev, kernel, B, case):
    """Both kernels in the listed design at B = 12,000, 16,384 and 65,536:
    within one rounding step of the plain version, a NaN in its own
    entries, the same bits twice; one pre-pass launch and one main launch
    a call."""
    rng = np.random.default_rng(B + len(case))
    f = 5
    if kernel == "hist_full":
        n = 100_003
        bins = _listed_bins(rng, case, (n, f + 2), B, dev)
        g, h, m = _rows(rng, n, dev)

        def call():
            return thist.build_histogram(bins, g, h, m, B, f_limit=f)
    else:
        k, BR, nb = 8, 512, 40
        n = nb * BR
        comb = torch.cat([_listed_bins(rng, case, (n, f), B, dev),
                          torch.as_tensor(rng.integers(0, 65_536, (n, 6))
                                          .astype(np.uint16)).to(dev)], 1)
        g, h, m = _rows(rng, n, dev)
        bl = torch.as_tensor(_leaf_map(rng, "random", nb, k)).to(dev)

        def call():
            return thist.build_histogram_leaves(comb, g, h, m, bl, k, B,
                                                block_rows=BR, f_limit=f)
    if case == "nan":                       # row 77's bins all below B
        g[77] = float("nan")
        (bins if kernel == "hist_full" else comb)[77, :f] = 5
    with thist.force_plain():
        ref = call()
    before = dict(thist.launch_counts)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert thist.launch_counts[kernel] == before[kernel] + 2
    assert thist.launch_counts["hist_lists"] == before["hist_lists"] + 2
    _hold_atomic(got, again, ref)
    if case == "all_high":
        assert bool((got == 0).all())
    if case == "nan":
        assert 0 < int(torch.isnan(got).sum()) <= 3 * f


@pytest.mark.parametrize("slotted", (False, True))
@pytest.mark.parametrize("B", (12_000, 16_384, 65_536))
def test_bin_lists_kernel_matches_plain_bit_for_bit(dev, B, slotted):
    """The pre-pass kernel (``hist_lists``) against its plain version: the
    same lists, tables and unit numbers, bit for bit, on Zipf-skewed bins
    with bins >= B (below 65,536) and zero rows, for the full pass (ragged last block)
    and per slot (an unsorted map, blocks of no slot, a slot no block
    names); its gh4, bit for bit (g*m, h*m, m) on every row of a listed
    block; one launch a call."""
    rng = np.random.default_rng(B + slotted)
    f = 4
    if slotted:
        k, BR, nb = 8, 512, 40
        n = nb * BR
        bl = torch.as_tensor(_leaf_map(rng, "random", nb, k)).to(dev)
        kw = dict(block_rows=BR, block_leaf=bl, num_slots=k)
    else:
        n, kw = 50_001, dict(block_rows=4096)
    bins = _wide_u16(rng, (n, f + 1), B, "zipf", dev)
    if B < 65_536:                          # bins >= B on every 7th row
        bins[::7] = B + 3
    g, h, m = _rows(rng, n, dev)            # a fifth of the rows zero
    before = thist.launch_counts["hist_lists"]
    got = thist.bin_lists(bins, g, h, m, B, f_limit=f, unit=1000, **kw)
    ref = thist.bin_lists_plain(bins, g, h, m, B, f_limit=f, unit=1000,
                                **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_lists"] == before + 1
    assert thist.lists_equal(got, ref)
    assert int(got.seg_len.sum()) == int(ref.counts().sum()) > 0
    rows = torch.arange(n, device=dev)
    if slotted:                             # rows of blocks of a slot
        slot = bl[rows // BR]
        rows = rows[(slot >= 0) & (slot < k)]
    gh = got.gh4.view(-1, 4)[rows]
    want = torch.stack((g * m, h * m, m, torch.zeros_like(m)), 1)[rows]
    assert rows.numel() > 0
    assert torch.equal(gh.view(torch.int32), want.view(torch.int32))


def test_training_wide_bins_launches_both_kernels_and_matches_plain(dev):
    """max_bin=12000 (a width above one feature's CTA) on both growers:
    the kernels launch (the root and every frontier round; the serial
    grower's one K1 a split) and grow force_plain()'s trees."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(12)
    n = 40_000
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
         > 0).astype(np.float32)
    for grower in ("frontier", "serial"):
        params = {"objective": "binary", "num_leaves": 15, "max_bin": 12000,
                  "tree_grower": grower, "verbose": -1}
        ds = lgt.Dataset(X, label=y, params=params).construct(dev)
        thist.reset_launch_counts()
        bk = lgt.train(params, ds, 3, verbose_eval=False, device="cuda")
        width = bk._gbdt._grower_cfg.max_bin
        assert width > 9685
        assert thist.atomic_geometry(3, width, 3, 2)["tiles"] > 1
        if grower == "frontier":
            assert thist.launch_counts["hist_full"] == 3
            assert thist.launch_counts["hist_leaves"] >= 3
        else:
            assert thist.launch_counts["hist_full"] > 3
            assert thist.launch_counts["hist_leaves"] == 0
        with thist.force_plain():
            bp = lgt.train(params, ds, 3, verbose_eval=False, device="cuda")
        for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
            assert np.array_equal(tk.split_feature, tp.split_feature)
            assert np.array_equal(tk.threshold, tp.threshold)
        np.testing.assert_array_equal(bk.predict(X[:2000]),
                                      bp.predict(X[:2000]))


def test_xendcg_draw_on_the_card_equals_the_cpu(dev):
    """rank_xendcg's per-iteration [Q, L] uniforms are integer ops: the
    card's are the CPU's bit for bit."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective.rank import RankXENDCG
    rng = np.random.default_rng(11)
    sizes = rng.integers(1, 300, 500)
    md = Metadata(int(sizes.sum()))
    md.set_field("label", rng.integers(0, 5, int(sizes.sum())))
    md.set_field("group", sizes)
    obj = RankXENDCG(Config.from_params({"objective": "rank_xendcg"}))
    obj.init(md, int(sizes.sum()))
    for it in (0, 3):
        assert torch.equal(obj.draw(it, dev).cpu(), obj.draw(it, "cpu"))


# ---------------------------------------------------------------------------
# u16 bins: the one-hot kernels' uint16 instantiations (base, i16cmp,
# staged, int8) at B = 300 (Bp = 384, not a power of two), 1,024 and
# 2,599 (Bp = 2,688: a CTA's 512 lanes hold part of one feature)
# ---------------------------------------------------------------------------

U16_BODIES = ("base", "i16cmp", "staged", "int8")
U16_WIDTHS = (300, 1024, 2599)
ONEHOT_U16 = [(v, B) for B in U16_WIDTHS for v in U16_BODIES]


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("variant,B", ONEHOT_U16)
def test_onehot_full_u16_matches_plain(dev, variant, B, layout):
    rng = np.random.default_rng(B + 5)
    n, f, ncols = 50_003, 13, 16               # ragged rows, f_limit < NC
    bins = _u16(rng, (n, ncols), B + 100, dev)  # bins >= B are dropped
    g, h, m = _rows(rng, n, dev)
    kw = dict(f_limit=f, method="onehot", variant=variant, layout=layout)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, **kw)
    before = dict(thist.launch_counts)
    got = thist.build_histogram(bins, g, h, m, B, **kw)
    again = thist.build_histogram(bins, g, h, m, B, **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_full"] == before["onehot_full"] + 2
    assert thist.launch_counts["hist_full"] == before["hist_full"]
    assert got.shape == (f, B, 3) and got.dtype == torch.float32
    assert relerr(got, ref) <= TOL
    assert torch.equal(got, again)


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("variant,B", ONEHOT_U16)
def test_onehot_full_u16_nan_matches_plain(dev, variant, B, layout):
    rng = np.random.default_rng(B + 6)
    n, f = 20_000, 5
    bins = _u16(rng, (n, f), B, dev)
    g, h, m = _rows(rng, n, dev)
    g[12_345] = float("nan")
    kw = dict(method="onehot", variant=variant, layout=layout)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, **kw)
    got = thist.build_histogram(bins, g, h, m, B, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[..., 0]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert relerr(got[..., 1:], ref[..., 1:]) <= TOL


@pytest.mark.parametrize("variant,B", ONEHOT_U16)
def test_onehot_leaves_u16_matches_plain(dev, variant, B):
    """The frontier's comb of u16 bins and 6 gh columns, inside the leaves
    cut: an empty slot stays zero, a NaN stays in its slot."""
    rng = np.random.default_rng(B + 7)
    k, BR, f = 6, 512, 8
    nc = f + 6
    block_leaf = np.array([4, 0, 2, 4, 1, 5, 0, 2, 1, 4], np.int32)  # 3 empty
    C = block_leaf.size * BR
    comb = _u16(rng, (C, nc), B + 100, dev)
    g, h, m = _rows(rng, C, dev)
    nan_block = 5
    g[nan_block * BR + 3] = float("nan")
    bl = torch.as_tensor(block_leaf).to(dev)
    assert thist.onehot_leaves_fits(f, k, B)
    kw = dict(block_rows=BR, f_limit=f, method="onehot", variant=variant)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    before = dict(thist.launch_counts)
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_leaves"] == before["onehot_leaves"] + 2
    assert thist.launch_counts["hist_leaves"] == before["hist_leaves"]
    assert got.shape == (k, f, B, 3)
    assert bool((got[3] == 0).all())
    nan_slot = int(block_leaf[nan_block])
    assert bool(torch.isnan(got[nan_slot][..., 0]).all())
    others = [s for s in range(k) if s != nan_slot]
    assert bool(torch.isfinite(got[others]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL
    assert torch.equal(got[others], again[others])


def _edge_u16(rng, case, n, ncols, B, dev):
    if case == "one_bin":                       # every row in the last bin
        return torch.full((n, ncols), B - 1, dtype=torch.int16,
                          device=dev).view(torch.uint16)
    if case == "narrow":                        # 16 bins mid-range
        lo = B // 2
        return torch.as_tensor(rng.integers(lo, lo + 16, (n, ncols)).astype(
            np.uint16)).to(dev)
    return _u16(rng, (n, ncols), B + 100, dev)


# (case, n, f, ncols): fewer rows than one chunk; a ragged last chunk; one
# bin (the last lane of the last warp); 16 bins mid-range (one warp's
# lanes: the other warps see only bins below or above theirs); rows wider
# than the kernels stage as they lie (300 u16 = 600 bytes)
FULL_EDGES_U16 = [("tiny", 100, 3, 5), ("ragged", 1037, 5, 7),
                  ("one_bin", 700, 5, 5), ("narrow", 515, 5, 6),
                  ("wide", 400, 5, 300)]


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("case,n,f,ncols", FULL_EDGES_U16)
@pytest.mark.parametrize("variant,B", ONEHOT_U16)
def test_onehot_full_u16_edges_match_plain(dev, variant, B, case, n, f,
                                           ncols, layout):
    rng = np.random.default_rng(n + B)
    bins = _edge_u16(rng, case, n, ncols, B, dev)
    g, h, m = _rows(rng, n, dev)
    kw = dict(f_limit=f, method="onehot", variant=variant, layout=layout)
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, **kw)
    got = thist.build_histogram(bins, g, h, m, B, **kw)
    again = thist.build_histogram(bins, g, h, m, B, **kw)
    torch.cuda.synchronize()
    assert got.shape == (f, B, 3)
    assert relerr(got, ref) <= TOL
    assert torch.equal(got, again)


# (case, f, nc): a row of 19 u16 (38 bytes, no multiple of 16); a NaN
# block; rows wider than the kernels stage as they lie; a matrix that
# does not start 16-byte aligned
LEAVES_EDGES_U16 = [("ld19", 11, 19), ("nan_block", 11, 19),
                    ("wide", 7, 300), ("unaligned", 11, 19)]


@pytest.mark.parametrize("case,f,nc", LEAVES_EDGES_U16)
@pytest.mark.parametrize("variant,B", ONEHOT_U16)
def test_onehot_leaves_u16_edges_match_plain(dev, variant, B, case, f, nc):
    rng = np.random.default_rng(nc + B)
    k, BR = 5, 256
    block_leaf = np.array([3, 0, 3, 1, 4, 0, 2], np.int32)
    C = block_leaf.size * BR
    raw = _u16(rng, (C + 1, nc), B + 100, dev)
    comb = raw[1:] if case == "unaligned" else raw[:C]
    assert comb.is_contiguous()
    g, h, m = _rows(rng, C, dev)
    nan_slot = None
    if case == "nan_block":
        g[4 * BR + 9] = float("nan")
        nan_slot = int(block_leaf[4])
    bl = torch.as_tensor(block_leaf).to(dev)
    assert thist.onehot_leaves_fits(f, k, B)
    kw = dict(block_rows=BR, f_limit=f, method="onehot", variant=variant)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    before = thist.launch_counts["onehot_leaves"]
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_leaves"] == before + 2
    assert got.shape == (k, f, B, 3)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    if nan_slot is not None:
        assert bool(torch.isnan(got[nan_slot][..., 0]).all())
        others = [s for s in range(k) if s != nan_slot]
        assert bool(torch.isfinite(got[others]).all())
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL
    assert torch.equal(got[fin], again[fin])


def test_onehot_leaves_outside_the_cut_take_hist_leaves(dev):
    """33 features at B = 1,024 (33,792 lanes) lie outside the JAX
    package's cut: the one-hot method's per-leaf call launches the atomic
    kernel, and gives its bits."""
    rng = np.random.default_rng(33)
    k, BR, f = 4, 512, 33
    block_leaf = np.array([1, 0, 3, 2, 1], np.int32)
    C = block_leaf.size * BR
    comb = _u16(rng, (C, f + 6), 1100, dev)
    g, h, m = _rows(rng, C, dev)
    bl = torch.as_tensor(block_leaf).to(dev)
    assert not thist.onehot_leaves_fits(f, k, 1024)
    kw = dict(block_rows=BR, f_limit=f)
    before = dict(thist.launch_counts)
    got = thist.build_histogram_leaves(comb, g, h, m, bl, k, 1024,
                                       method="onehot", variant="staged",
                                       **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_leaves"] == before["hist_leaves"] + 1
    assert thist.launch_counts["onehot_leaves"] == before["onehot_leaves"]
    assert torch.equal(got, thist.hist_leaves(comb, g, h, m, bl, k, 1024,
                                              **kw))


@pytest.mark.parametrize("variant,B", [(v, B) for B in U16_WIDTHS
                                       for v in ("base", "staged", "int8")])
def test_bench_kernel_u16_matches_plain(dev, variant, B):
    """K4 on u16 bins as the caller transposed them."""
    rng = np.random.default_rng(B + 9)
    n, f, BR = 65_536, 28, 512
    bins_t = _u16(rng, (f, n), B, dev)
    g, h, m = _rows(rng, n, dev)
    prep, run = ov.make_bench_kernel(variant, f, B, BR)
    rows = prep(g, h, m)
    with thist.force_plain():
        ref = run(bins_t, rows)
    before = dict(thist.launch_counts)
    got = run(bins_t, rows)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_bench"] == before["onehot_bench"] + 1
    assert got.shape == (f, B, 3)
    assert relerr(got, ref) <= TOL


def test_onehot_u16_kernel_attributes_and_refusals(dev):
    """Each u16 body's kernels report their attributes; a body with no u16
    instantiation is refused by the wrapper, and by the C entry."""
    for v in U16_BODIES:
        for kernel, layout in (("onehot_full", "featmajor"),
                               ("onehot_full", "rowmajor"),
                               ("onehot_leaves", "rowmajor")):
            a = thist.onehot_kernel_attributes(kernel, v, 28, 1024, layout,
                                               ld=34)
            assert 0 < a["registers"] <= 255 and a["ctas_per_sm"] >= 1
            assert a["dynamic_smem_bytes"] <= thist.SMEM_MAX_BYTES
    bins = torch.zeros(1024, 4, dtype=torch.uint16, device=dev)
    z = torch.zeros(1024, device=dev)
    for v in ("bf16cmp", "u8cmp", "sub1abs", "packed"):
        with pytest.raises(ValueError, match="does not support"):
            thist.hist_onehot_full(bins, z, z, z, 1024, variant=v)
        # u16 bins at a width the body serves: the C entry refuses
        with pytest.raises(RuntimeError, match="launch failed"):
            thist.hist_onehot_full(bins, z, z, z, 64, variant=v)


# ---------------------------------------------------------------------------
# u16 bins: the one-hot kernels' two designs (histogram.onehot_plan: the
# bucketed design at u16, rows sorted by their 128-lane bucket; the dense
# one by override) on crafted bins
# ---------------------------------------------------------------------------

def _crafted_onehot_u16(rng, case, n, f, B, dev):
    """u16 bins [n, f] of one crafted case."""
    nb = ov.padded_bins(B) // 128
    if case == "one_bucket":                  # every row in bucket 2
        b = rng.integers(256, 384, (n, f))
    elif case == "ragged_counts":             # buckets of 1, 2, ... rows
        bucket = np.minimum(np.arange(n)[:, None] % 37 // 3 % nb, nb - 1)
        b = bucket * 128 + rng.integers(0, 128, (n, f))
    elif case == "pad_lanes":                 # bins in [B, Bp) and >= Bp
        b = rng.integers(B - 60, ov.padded_bins(B) + 200, (n, f))
    elif case == "zipf":
        p = 1.0 / np.arange(1, B + 1) ** 1.1
        b = rng.choice(B, size=(n, f), p=p / p.sum())
    else:                                     # "bundle": a default bin
        b = np.where(rng.random((n, f)) < 0.9, 0, rng.integers(0, B, (n, f)))
    return torch.as_tensor(b.astype(np.uint16)).to(dev)


# (case, B, f): f = 3 at B = 2,599 (Bp = 2,688) ends its last feature
# inside a dense CTA's 512 lanes, and takes 3 bucketed CTAs a feature
CRAFTED_U16 = [("one_bucket", 1024, 5), ("ragged_counts", 1024, 5),
               ("pad_lanes", 1000, 5), ("zipf", 1024, 5),
               ("bundle", 2599, 3), ("nan", 1024, 5)]


@pytest.mark.parametrize("design", thist.ONEHOT_DESIGNS)
@pytest.mark.parametrize("case,B,f", CRAFTED_U16)
@pytest.mark.parametrize("variant", U16_BODIES)
def test_onehot_full_u16_designs_match_plain(dev, variant, case, B, f,
                                             design):
    """K1 feature-major in both designs: every crafted case within TOL of
    plain, a NaN in one chunk over its whole channel, the same bits from
    two calls, one launch each."""
    rng = np.random.default_rng(B + f + len(case))
    n = 20_011
    bins = _crafted_onehot_u16(rng, "ragged_counts" if case == "nan"
                               else case, n, f, B, dev)
    g, h, m = _rows(rng, n, dev)
    if case == "nan":
        g[5_000] = float("nan")
    kw = dict(method="onehot", variant=variant, layout="featmajor")
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, **kw)
    with thist.onehot_design(design):
        assert thist.onehot_kernel_attributes(
            "onehot_full", variant, f, B, "featmajor")["design"] == design
        before = thist.launch_counts["onehot_full"]
        got = thist.build_histogram(bins, g, h, m, B, **kw)
        again = thist.build_histogram(bins, g, h, m, B, **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_full"] == before + 2
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    if case == "nan":
        assert bool(torch.isnan(got[..., 0]).all())
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL
    assert torch.equal(got[fin], again[fin])


@pytest.mark.parametrize("design", thist.ONEHOT_DESIGNS)
@pytest.mark.parametrize("case,B,f", CRAFTED_U16)
@pytest.mark.parametrize("variant", U16_BODIES)
def test_onehot_leaves_u16_designs_match_plain(dev, variant, case, B, f,
                                               design):
    """K2 in both designs on the frontier's comb (f u16 features and 6 gh
    columns): every crafted case within TOL of plain, an empty slot zero,
    a NaN block confined to its slot, the same bits from two calls."""
    rng = np.random.default_rng(B + f + len(case) + 1)
    k, BR = 6, 512
    block_leaf = np.array([4, 0, 2, 4, 1, 5, 0, 2, 1, 4], np.int32)  # 3 empty
    C = block_leaf.size * BR
    bins = _crafted_onehot_u16(rng, "ragged_counts" if case == "nan"
                               else case, C, f, B, dev)
    g, h, m = _rows(rng, C, dev)
    nan_slot = None
    if case == "nan":
        g[5 * BR + 77] = float("nan")
        nan_slot = int(block_leaf[5])
    mv = thist.movable_bins(bins)
    gh = torch.stack([g, h, m], 1).contiguous().view(torch.int16)
    comb = torch.cat([mv, gh], 1).view(torch.uint16)
    bl = torch.as_tensor(block_leaf).to(dev)
    assert thist.onehot_leaves_fits(f, k, B)
    kw = dict(block_rows=BR, f_limit=f, method="onehot", variant=variant)
    with thist.force_plain():
        ref = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    with thist.onehot_design(design):
        before = thist.launch_counts["onehot_leaves"]
        got = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
        again = thist.build_histogram_leaves(comb, g, h, m, bl, k, B, **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_leaves"] == before + 2
    assert bool((got[3] == 0).all())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    if nan_slot is not None:
        assert bool(torch.isnan(got[nan_slot][..., 0]).all())
        others = [s for s in range(k) if s != nan_slot]
        assert bool(torch.isfinite(got[others]).all())
    fin = torch.isfinite(ref)
    assert relerr(got[fin], ref[fin]) <= TOL
    assert torch.equal(got[fin], again[fin])


def test_onehot_plan_matches_the_kernels_query(dev):
    """The plan's design and shared bytes are the kernels' own: bucketed at
    u16 (each body, both layouts and the leaves, int8 over 512-row blocks
    and over the row-major layout's 128-row ones), dense at u8."""
    for v in U16_BODIES:
        plan = thist.onehot_plan(v, 28, 1024)
        for kernel, layout in (("onehot_full", "featmajor"),
                               ("onehot_full", "rowmajor"),
                               ("onehot_leaves", "rowmajor")):
            a = thist.onehot_kernel_attributes(kernel, v, 28, 1024, layout,
                                               ld=34, block_rows=512)
            assert a["design"] == plan["design"] == "bucketed"
            assert a["dynamic_smem_bytes"] == plan["dynamic_smem_bytes"]
            assert a["ctas_per_sm"] >= 1
    assert thist.onehot_kernel_attributes(
        "onehot_full", "staged", 28, 255, "featmajor")["design"] == "dense"
    # int8 over the row-major layout's 128-row blocks: bucketed as well, in
    # the kernel whose segments span the blocks
    a = thist.onehot_kernel_attributes("onehot_full", "int8", 28, 1024,
                                       "rowmajor")
    assert a["design"] == "bucketed"
    assert a["dynamic_smem_bytes"] == thist.onehot_plan(
        "int8", 28, 1024, 128)["dynamic_smem_bytes"]
    assert a["dynamic_smem_bytes"] > thist.onehot_plan(
        "int8", 28, 1024, 512)["dynamic_smem_bytes"]
    assert a["ctas_per_sm"] == 2


# ---------------------------------------------------------------------------
# u16 int8 over quantization blocks of 128-512 rows: the bucketed design,
# whose 512-row segments span the blocks of fewer rows, bit for bit its
# plain version
# ---------------------------------------------------------------------------

INT8_BLOCKS = [(br, B) for br in (128, 256, 384, 512)
               for B in (1024, 1536, 2599, 4096, 65_536)]


def _int8_bits(got, ref):
    """NaN where the plain version is NaN, and its bits elsewhere (a NaN's
    payload is not part of the function)."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert _same_bits(got[~nan], ref[~nan])


@pytest.mark.parametrize("layout", ["featmajor", "rowmajor"])
@pytest.mark.parametrize("br,B", INT8_BLOCKS)
def test_onehot_int8_blocks_match_plain_bit_for_bit(dev, monkeypatch, layout,
                                                    br, B):
    """int8 quantized in blocks of br rows (the JAX package's
    pallas_block_rows, patched here for the kernel and the plain version
    alike): the bucketed design in both layouts, bit for bit the plain
    version, with rows at bins past B, masked rows, a ragged last block
    and a NaN gradient in one block (its scale NaN: channel 0 NaN on every
    lane, the others finite); the same bits twice, one launch a call."""
    monkeypatch.setattr(ov, "pallas_block_rows", lambda *a, **kw: br)
    rng = np.random.default_rng(br + B)
    f = 3 if B < 65_536 else 2
    n = 12_345
    bins = torch.as_tensor(rng.integers(0, min(B + B // 8, 65_536),
                                        (n, f + 1)).astype(np.uint16)
                           ).to(dev)
    g, h, m = _rows(rng, n, dev)
    g[5 * br + 17] = float("nan")
    kw = dict(method="onehot", variant="int8", layout=layout, f_limit=f)
    assert thist.onehot_plan("int8", f, B, br)["design"] == "bucketed"
    with thist.force_plain():
        ref = thist.build_histogram(bins, g, h, m, B, **kw)
    before = thist.launch_counts["onehot_full"]
    got = thist.build_histogram(bins, g, h, m, B, **kw)
    again = thist.build_histogram(bins, g, h, m, B, **kw)
    torch.cuda.synchronize()
    assert thist.launch_counts["onehot_full"] == before + 2
    assert bool(torch.isnan(got[..., 0]).all())
    assert bool(torch.isfinite(got[..., 1:]).all())
    _int8_bits(got, ref)
    _int8_bits(again, got)


@pytest.mark.parametrize("kernel", ("hist_full", "hist_leaves"))
def test_listed_call_under_a_quarter_budget_matches_one_pass(dev, kernel):
    """A listed K1 or K2 call (B = 12,000) held to a quarter of its one
    pass's lists (histogram.list_budget) runs its features in passes
    (list_passes, each within the budget): bit for bit the one-pass call,
    the pre-pass and the main kernel launched once a pass, and the
    device's peak allocation during the call within the budget plus its
    output (and the allocator's rounding of the two, 512 bytes each)."""
    B, f = 12_000, 28
    rng = np.random.default_rng(11)
    if kernel == "hist_full":
        n, k = 200_003, 1
        mat = _wide_u16(rng, (n, f + 1), B, "random", dev)
        g, h, m = _rows(rng, n, dev)

        def call():
            return thist.build_histogram(mat, g, h, m, B, f_limit=f)
        plan = thist.atomic_plan(kernel, dev, f + 1, f, B, esz=2)
        cr = plan["list_rows"]
    else:
        k, BR, nb = 8, 512, 200
        n = nb * BR
        mat = torch.cat([_wide_u16(rng, (n, f), B, "random", dev),
                         torch.as_tensor(rng.integers(0, 65_536, (n, 6))
                                         .astype(np.uint16)).to(dev)], 1)
        g, h, m = _rows(rng, n, dev)
        bl = torch.as_tensor(_leaf_map(rng, "random", nb, k)).to(dev)

        def call():
            return thist.build_histogram_leaves(mat, g, h, m, bl, k, B,
                                                block_rows=BR, f_limit=f)
        plan = thist.atomic_plan(kernel, dev, f + 6, f, B, esz=2)
        cr = thist.list_chunk_rows(BR)
    assert plan["design"] == 2
    budget = thist.list_pass_bytes(plan, f, n, k, cr) // 4
    passes = thist.list_passes(plan, f, n, k, cr, budget)
    assert len(passes) >= 4
    assert all(thist.list_pass_bytes(plan, fp, n, k, cr) <= budget
               for _, fp in passes)
    ref = call()
    torch.cuda.synchronize()
    before = dict(thist.launch_counts)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with thist.list_budget(budget):
        got = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak <= budget + 4 * f * B * 3 * k + 2 * 512
    assert thist.launch_counts[kernel] == before[kernel] + len(passes)
    assert thist.launch_counts["hist_lists"] == (before["hist_lists"]
                                                 + len(passes))
    assert _same_bits(got, ref)


def test_listed_call_sizes_its_passes_when_one_does_not_fit(dev,
                                                            monkeypatch):
    """Where a listed call's one buffer cannot be allocated (the
    OutOfMemoryError made here for any pass of more than a third of the
    features), the call halves the pass that failed and the rest until
    they fit (28 -> 14 -> 7 features a pass): the same bits as one pass,
    the kernel launched once a pass; a second call of the shape takes the
    passes it kept at once, with no failed allocation."""
    B, f, n = 12_000, 28, 100_003
    rng = np.random.default_rng(13)
    mat = _wide_u16(rng, (n, f), B, "random", dev)
    g, h, m = _rows(rng, n, dev)
    ref = thist.build_histogram(mat, g, h, m, B)
    real = thist._list_buffer
    refused = []

    def buffer(nbytes, device, rows, fp):
        if fp > f // 3:
            refused.append(fp)
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(nbytes, device, rows, fp)
    monkeypatch.setattr(thist, "_list_buffer", buffer)
    monkeypatch.setattr(thist, "_list_passes_taken", {})
    before = thist.launch_counts["hist_full"]
    got = thist.build_histogram(mat, g, h, m, B)
    torch.cuda.synchronize()
    assert refused == [28, 14]
    assert thist.launch_counts["hist_full"] == before + 4
    assert _same_bits(got, ref)
    assert list(thist._list_passes_taken.values()) == [
        [(0, 7), (7, 7), (14, 7), (21, 7)]]
    again = thist.build_histogram(mat, g, h, m, B)
    torch.cuda.synchronize()
    assert refused == [28, 14]
    assert thist.launch_counts["hist_full"] == before + 8
    assert _same_bits(again, ref)


def test_election_on_the_card_at_u16(dev):
    """At B = 1,024 the election times base, staged and int8 on u16 bins,
    and every one passes parity."""
    name = torch.cuda.get_device_name(dev)
    ov._AUTO_CACHE.pop((name, 1024), None)
    won = ov.pick_variant(1024, 28, device=dev)
    res = ov.AUTO_RESULTS[(name, 1024)]
    assert set(res) == {"base", "staged", "int8"}
    assert all(r["qualified"] for r in res.values()), res
    assert won == min(res, key=lambda v: res[v]["ms"])


@pytest.mark.parametrize("variant,nf", [("staged", 10), ("int8", 10),
                                        ("base", 40), ("auto", 10)])
def test_training_force_row_wise_u16_launches_onehot(dev, variant, nf):
    """force_row_wise at max_bin=1023: the root through onehot_full, and
    the per-leaf histograms through onehot_leaves inside the leaves cut
    (10 features: 10,240 lanes) or hist_leaves outside it (40 features);
    the trees of the same run under force_plain() on the card."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(nf)
    X = rng.normal(size=(30_000, nf)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=30_000)
         > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "force_row_wise": True, "hist_variant": variant,
              "max_bin": 1023}
    if variant == "auto":                      # elect outside the count
        elected = ov.pick_variant(1024, nf, device=dev)
    ds = lgt.Dataset(X, label=y, params=params).construct(dev)
    assert ds._inner.bins.dtype == np.uint16
    thist.reset_launch_counts()
    bk = lgt.train(params, ds, 5, verbose_eval=False, device="cuda")
    used = bk._gbdt._grower_cfg.hist_variant
    assert used == (elected if variant == "auto" else variant)
    inside = thist.onehot_leaves_fits(nf, bk._gbdt._grower_cfg.frontier_k,
                                      1024)
    assert inside == (nf == 10)
    assert (thist.launch_counts["onehot_quant"] > 0) == (used == "int8")
    assert thist.launch_counts["onehot_full"] == 5
    assert thist.launch_counts["hist_full"] == 0
    assert (thist.launch_counts["onehot_leaves"] >= 5) == inside
    assert (thist.launch_counts["hist_leaves"] >= 5) == (not inside)
    with thist.force_plain():
        bp = lgt.train(params, ds, 5, verbose_eval=False, device="cuda")
    for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
        assert np.array_equal(tk.split_feature, tp.split_feature)
        assert np.array_equal(tk.threshold, tp.threshold)


def test_training_force_row_wise_on_a_wide_bundle(dev):
    """EFB bundles wider than 256 bins (a 400-level one-hot) under
    force_row_wise staged: one-hot kernels, the trees of force_plain()."""
    import scipy.sparse as sp
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(4)
    n = 30_000
    X = rng.normal(size=(n, 6)).astype(np.float32)
    cats = rng.integers(0, 400, n)
    Xs = sp.hstack([sp.csr_matrix((np.ones(n), (np.arange(n), cats)),
                                  shape=(n, 400)), sp.csr_matrix(X)]).tocsr()
    y = ((cats % 7 < 3) ^ (X[:, 0] > 0)).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1,
              "force_row_wise": True, "hist_variant": "staged"}
    ds = lgt.Dataset(Xs, label=y, params=params).construct(dev)
    thist.reset_launch_counts()
    bk = lgt.train(params, ds, 3, verbose_eval=False, device="cuda")
    assert bk._gbdt._grower_cfg.bundle_bins > 256
    assert thist.launch_counts["onehot_full"] == 3
    assert thist.launch_counts["hist_full"] == 0
    with thist.force_plain():
        bp = lgt.train(params, ds, 3, verbose_eval=False, device="cuda")
    for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
        assert np.array_equal(tk.split_feature, tp.split_feature)
        assert np.array_equal(tk.threshold, tp.threshold)


def _engine_data(n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + rng.logistic(size=n) > 0
         ).astype(np.float32)
    return X, y


ENGINE_PARAMS = {"objective": "binary", "num_leaves": 31, "verbose": -1,
                 "feature_fraction": 0.8, "bagging_freq": 2,
                 "bagging_fraction": 0.8}


def test_file_dataset_trains_the_trees_of_its_arrays(dev, tmp_path):
    """A TSV with a .weight sidecar, parsed by the native parser, trains on
    the card (through hist_full and hist_leaves) the trees of the matrix
    the file holds given in memory (its float32 values to nine digits)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.io.loader import load_file
    X, y = _engine_data()
    w = np.random.default_rng(6).uniform(0.5, 1.5, len(y)).round(4)
    path = tmp_path / "binary.train"
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    np.savetxt(str(path) + ".weight", w, fmt="%.4f")
    calls = native.native_calls["parse_delimited"]
    thist.reset_launch_counts()
    bf = lgt.train(ENGINE_PARAMS, lgt.Dataset(str(path)), 4,
                   verbose_eval=False, device="cuda")
    assert native.native_calls["parse_delimited"] == calls + 1
    assert thist.launch_counts["hist_full"] == 4
    assert thist.launch_counts["hist_leaves"] > 0
    Xf = load_file(str(path))[0]
    assert np.array_equal(Xf.astype(np.float32), X)
    ba = lgt.train(ENGINE_PARAMS, lgt.Dataset(Xf, label=y, weight=w), 4,
                   verbose_eval=False, device="cuda")
    assert bf.model_to_string() == ba.model_to_string()


def test_continue_from_warms_device_scores_like_a_single_run(dev, tmp_path):
    import lightgbm_tpu_torch as lgt
    X, y = _engine_data()
    ds = lgt.Dataset(X, label=y)
    first = lgt.train(ENGINE_PARAMS, ds, 3, verbose_eval=False,
                      device="cuda")
    path = str(tmp_path / "m.txt")
    first.save_model(path)
    cont = lgt.Booster(params=ENGINE_PARAMS, train_set=lgt.Dataset(X, label=y),
                       device="cuda")
    cont._gbdt.continue_from(lgt.Booster(model_file=path,
                                         device="cuda")._gbdt)
    score = cont._gbdt._train_score
    assert score.device.type == "cuda"
    # the warm replays the single run's float32 updates: bit for bit
    assert torch.equal(score, first._gbdt._train_score)


def test_rollback_restores_device_scores_bit_for_bit(dev):
    import lightgbm_tpu_torch as lgt
    X, y = _engine_data()
    ds = lgt.Dataset(X, label=y)
    b = lgt.Booster(params=ENGINE_PARAMS, train_set=ds, device="cuda")
    b.add_valid(ds.create_valid(X[:5000], label=y[:5000]), "valid")
    for _ in range(3):
        b.update()
    g = b._gbdt
    before = g._train_score.clone(), g._valid_scores[0].clone()
    text = b.model_to_string()
    b.update()
    again = b.model_to_string()
    b.rollback_one_iter()
    assert torch.equal(g._train_score, before[0])
    assert torch.equal(g._valid_scores[0], before[1])
    assert b.model_to_string() == text
    b.update()
    assert b.model_to_string() == again


def test_fobj_gradients_arrive_on_the_models_device(dev):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    X, y = _engine_data()
    seen = []
    real = gbdt_mod.GBDT._bagging_weights

    def spy(self, iteration, grad, hess):
        seen.append((grad.device, hess.device, grad.dtype, tuple(grad.shape)))
        return real(self, iteration, grad, hess)

    def fobj(score, dataset):
        p = 1.0 / (1.0 + np.exp(-score))
        return p - y, p * (1.0 - p)

    gbdt_mod.GBDT._bagging_weights = spy
    try:
        thist.reset_launch_counts()
        bt = lgt.train({"num_leaves": 31, "verbose": -1}, lgt.Dataset(X, label=y),
                       3, fobj=fobj, verbose_eval=False, device="cuda")
    finally:
        gbdt_mod.GBDT._bagging_weights = real
    assert bt.num_trees() == 3 and thist.launch_counts["hist_full"] == 3
    assert all(d1.type == "cuda" and d2.type == "cuda"
               and dt == torch.float32 and shape == (1, len(y))
               for d1, d2, dt, shape in seen) and len(seen) == 3


def _partitioned_block(rng, n, nc, dev, esz=1):
    """A parent segment as the serial grower gathers it: rows of a
    permuted bin matrix, its packed (grad, hess, weight) bytes, and the
    stable-partition side of each row."""
    hi = 256 if esz == 1 else 1024
    dt = np.uint8 if esz == 1 else np.uint16
    bins = torch.as_tensor(rng.integers(0, hi, (n, nc)).astype(dt)).to(dev)
    g, h, m = _rows(rng, n, dev)
    mv = thist.movable_bins(bins)
    comb = torch.cat([mv, torch.stack([g, h, m], 1).contiguous().view(
        mv.dtype)], 1)
    perm = torch.as_tensor(rng.permutation(n)).to(dev)
    seg = perm[n // 7: n // 7 + (n * 3) // 5]
    combb = comb[seg]
    ghb = combb[:, nc:].contiguous().view(torch.float32)
    side = thist.widen_bins(combb[:, 2]) <= hi // 3
    return combb.view(bins.dtype), ghb, side


@pytest.mark.parametrize("esz,B", [(1, 256), (2, 1024)])
def test_serial_grower_block_histogram_matches_plain(dev, esz, B):
    """The serial grower's smaller-child histogram: ``hist_full`` over a
    gathered parent segment (bins plus trailing gh columns, ``f_limit``
    the bin columns) with the child's side as mask, held against
    ``hist_full_plain`` on the same block, and the sibling by subtraction
    against the other side's plain histogram."""
    rng = np.random.default_rng(13 + esz)
    nc = 28
    combb, ghb, side = _partitioned_block(rng, 200_003, nc, dev, esz)
    g, h = ghb[:, 0].contiguous(), ghb[:, 1].contiguous()
    m_small = torch.where(side, ghb[:, 2], 0.0)
    m_other = torch.where(~side, ghb[:, 2], 0.0)
    before = thist.launch_counts["hist_full"]
    got = thist.build_histogram(combb, g, h, m_small, B, f_limit=nc)
    parent = thist.build_histogram(combb, g, h, ghb[:, 2].contiguous(), B,
                                   f_limit=nc)
    assert thist.launch_counts["hist_full"] == before + 2
    ref = thist.hist_full_plain(combb, g, h, m_small, B, f_limit=nc)
    ref_other = thist.hist_full_plain(combb, g, h, m_other, B, f_limit=nc)
    assert got.shape == (nc, B, 3)
    assert relerr(got, ref) <= TOL
    assert relerr(parent - got, ref_other) <= 1e-4


@pytest.mark.parametrize("params", [
    {},
    {"force_row_wise": True, "hist_variant": "staged"},
    {"interaction_constraints": [[0, 1, 2], [2, 3, 4, 5]]},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0, 0, -1],
     "monotone_constraints_method": "advanced"},
    {"cegb_penalty_split": 1e-4,
     "cegb_penalty_feature_coupled": [2.0] * 10}],
    ids=["atomic", "row_wise_staged", "interaction", "monotone_advanced",
         "cegb"])
def test_serial_training_launches_one_histogram_a_split(dev, params):
    """``tree_grower=serial`` on the card: one full-histogram launch for
    the root and one a split (``hist_full``, or ``onehot_full`` under
    ``force_row_wise``), no per-leaf kernel, and the trees of the same run
    under force_plain(); with no serial-only feature, the frontier's trees
    (the same leaves for every row)."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(1)
    X = rng.normal(size=(30_000, 10)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=30_000)
         > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 31, "verbose": -1,
         "tree_grower": "serial", **params}
    kernel = "onehot_full" if p.get("force_row_wise") else "hist_full"
    thist.reset_launch_counts()
    bk = lgt.train(p, lgt.Dataset(X, label=y), 4, verbose_eval=False,
                   device="cuda")
    leaves = sum(t.num_leaves for t in bk._gbdt.models)
    launched = {k: v for k, v in thist.launch_counts.items() if v}
    assert launched == {kernel: leaves}, launched
    with thist.force_plain():
        bp = lgt.train(p, lgt.Dataset(X, label=y), 4, verbose_eval=False,
                       device="cuda")
    for tk, tp in zip(bk._gbdt.models, bp._gbdt.models):
        assert np.array_equal(tk.split_feature, tp.split_feature)
        assert np.array_equal(tk.threshold, tp.threshold)
    if set(params) <= {"force_row_wise", "hist_variant"}:
        p.pop("tree_grower")
        bf = lgt.train(p, lgt.Dataset(X, label=y), 4, verbose_eval=False,
                       device="cuda")
        np.testing.assert_array_equal(bk.predict(X[:3000], pred_leaf=True),
                                      bf.predict(X[:3000], pred_leaf=True))


# ---------------------------------------------------------------------------
# the observability plane on the card
def test_record_watermarks_read_the_allocator(dev):
    """``obs.costs.record_watermarks`` on a CUDA device: the caching
    allocator's bytes in use and their peak, mirrored into the registry;
    the card's name prices against the H100 row or raises."""
    from lightgbm_tpu_torch.obs import costs, metrics
    from lightgbm_tpu_torch.utils.log import LightGBMError
    x = torch.empty(1 << 22, device=dev)
    reg = metrics.MetricsRegistry()
    wm = costs.record_watermarks("train", reg, dev)
    assert wm["peak_bytes_in_use"] >= wm["bytes_in_use"] >= x.numel() * 4
    snap = reg.snapshot()
    assert snap["train.device_bytes_in_use"]["value"] == wm["bytes_in_use"]
    assert (snap["train.device_peak_bytes_in_use"]["value"]
            == wm["peak_bytes_in_use"])
    name = torch.cuda.get_device_name(dev)
    if "H100" in name and "HBM3" in name:
        assert costs.current_chip(dev) == "h100"
    else:
        with pytest.raises(LightGBMError, match=name):
            costs.current_chip(dev)


def test_sentinels_copy_behind_a_cuda_event(dev):
    """The fast path's numeric sentinels: launched on the card, copied
    without blocking into pinned host memory behind an event, equal to the
    same reductions read synchronously."""
    from lightgbm_tpu_torch.models.gbdt import GBDT
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(1_000_003, device=dev, generator=gen)
    g[::7] = float("nan")
    h = torch.rand(1_000_003, device=dev, generator=gen)
    leaf = torch.randn(255, device=dev, generator=gen)
    stats, done = GBDT._health_launch(g, h, leaf)
    assert isinstance(done, torch.cuda.Event)
    assert stats.device.type == "cpu" and stats.is_pinned()
    done.synchronize()
    want = GBDT._health_stats(g, h, leaf).cpu()
    assert torch.equal(stats, want)
    assert stats[0, 0] < 1.0 and stats[1, 0] == 1.0


def test_nan_gradients_raise_divergence_on_the_card(dev, tmp_path):
    """C11 on the card: a NaN-gradient objective with
    ``obs_health_check_iters=1`` raises ``DivergenceError`` at iteration 0
    and leaves a flight dump beside the journal."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.obs import flight, health
    rng = np.random.default_rng(4)
    X = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)

    def nan_fobj(preds, ds):
        return np.full(len(preds), np.nan), np.ones(len(preds))
    params = {"objective": "none", "num_leaves": 15, "verbose": -1,
              "obs_telemetry": True, "obs_health_check_iters": 1,
              "obs_events_path": str(tmp_path / "journal.jsonl")}
    try:
        with pytest.raises(health.DivergenceError) as ei:
            lgt.train(params, lgt.Dataset(X, label=y), 3, fobj=nan_fobj,
                      verbose_eval=False, device="cuda")
    finally:
        flight.uninstall()
    assert ei.value.iteration == 0
    assert ei.value.flight_path.startswith(str(tmp_path))


# ---------------------------------------------------------------------------
# serving: the captured bucket graphs; out-of-core: the copy-streamed blocks
def test_serve_graph_capture_bit_exact_with_eager(dev):
    """One captured graph a bucket gives the eager device traversal's bits
    (``GBDT.predict`` with ``pred_device=device``), raw and transformed,
    padded and chunked, with a categorical split in the traversal."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.serve import PredictorArtifact
    X, y = _engine_data(4000)
    X[:, 3] = np.random.default_rng(1).integers(0, 9, len(X))
    y = np.where(X[:, 3] % 3 == 0, 1 - y, y)
    p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "pred_device": "device"}
    bst = lgt.train(p, lgt.Dataset(X, label=y, categorical_feature=[3]), 6,
                    verbose_eval=False, device="cuda")
    art = PredictorArtifact.freeze(bst, buckets=[64, 256])
    assert art.compile_count == 2 and len(art._graphs) == 2
    assert any(art._ens.has_cat)
    for n in (1, 63, 64, 65, 256, 600):
        assert np.array_equal(art.predict(X[:n]), bst.predict(X[:n])), n
        assert np.array_equal(art.predict(X[:n], raw_score=True),
                              bst.predict(X[:n], raw_score=True)), n
    full = art.predict(X[:64])
    assert np.array_equal(art.predict(X[5:6]), full[5:6])
    assert art.compile_count == 2
    ok, reason = art.parity_check(X[:500])
    assert ok, reason


@pytest.mark.parametrize("esz,B,method", [(1, 256, "atomic"),
                                          (2, 1024, "atomic"),
                                          (2, 12_000, "atomic"),
                                          (1, 256, "onehot")])
def test_accumulate_histogram_on_copy_streamed_blocks(dev, esz, B, method):
    """K1 on each pinned, copy-streamed block (``accumulate_histogram``)
    gives its plain version's bits on the same device block."""
    from lightgbm_tpu_torch.stream.host_matrix import HostBinMatrix
    from lightgbm_tpu_torch.stream.pipeline import (PipelineStats,
                                                    RowBlockPipeline)
    rng = np.random.default_rng(esz)
    n, f = 50_000, 28
    bins = rng.integers(0, B, (n, f)).astype(np.uint8 if esz == 1
                                               else np.uint16)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    stats = PipelineStats()
    pipe = RowBlockPipeline(HostBinMatrix(bins, 12_288), 2, stats, dev)
    acc = torch.zeros(f, B, 3, device=dev)
    ref = torch.zeros(f, B, 3, device=dev)
    variant = "staged" if method == "onehot" else "base"
    launches = thist.launch_counts["hist_full"] + \
        thist.launch_counts["onehot_full"]
    for blk in pipe.blocks({"g": g, "h": h, "rw": w}):
        args = (blk.bins, blk.extras["g"], blk.extras["h"],
                blk.extras["rw"], B)
        acc = thist.accumulate_histogram(acc, *args, method=method,
                                         variant=variant)
        with thist.force_plain():
            ref = thist.accumulate_histogram(ref, *args, method=method,
                                             variant=variant)
    torch.cuda.synchronize()
    assert thist.launch_counts["hist_full"] + \
        thist.launch_counts["onehot_full"] == launches + 5
    if method == "atomic":
        assert torch.equal(acc, ref)
    else:
        assert relerr(acc, ref) <= TOL
    assert stats.puts == 5 and stats.passes == 1
    assert pipe._slots[0].staging.is_pinned()


def test_ring_never_reuses_a_slot_before_its_event(dev):
    """The consumer's compute on each block is held back by a spin on the
    compute stream; the copies of later blocks into the same ring slot
    must wait for it, so what the compute reads is its own block."""
    from lightgbm_tpu_torch.stream.host_matrix import HostBinMatrix
    from lightgbm_tpu_torch.stream.pipeline import (PipelineStats,
                                                    RowBlockPipeline)
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 256, (8 * 1024, 16)).astype(np.uint8)
    g = rng.normal(size=len(bins)).astype(np.float32)
    stats = PipelineStats(events=[])
    pipe = RowBlockPipeline(HostBinMatrix(bins, 1024), 1, stats, dev)
    seen = []
    for blk in pipe.blocks({"g": g}):
        torch.cuda._sleep(5_000_000)         # keep the slot busy
        seen.append((blk.bins.clone(), blk.extras["g"].clone()))
    torch.cuda.synchronize()
    assert len(pipe._slots) == 2
    for i, (b, gg) in enumerate(seen):
        sl = slice(i * 1024, (i + 1) * 1024)
        assert np.array_equal(b.cpu().numpy(), bins[sl]), i
        assert np.array_equal(gg.cpu().numpy(), g[sl]), i
    # the timing events: one (copy, compute) pair of intervals a block
    assert len(stats.events) == 8
    for c0, c1, k0, k1 in stats.events:
        assert c0.elapsed_time(c1) >= 0 and k0.elapsed_time(k1) > 0


def test_stream_training_matches_serial_on_the_card(dev):
    """Streamed training on the card (hist_full a block) grows the
    in-memory serial grower's trees."""
    import lightgbm_tpu_torch as lgt
    X, y = _engine_data(20_000)
    p = {"objective": "binary", "num_leaves": 31, "verbose": -1,
         "tree_grower": "serial"}
    ref = lgt.train(p, lgt.Dataset(X, label=y), 3, device="cuda")
    thist.reset_launch_counts()
    sp = dict(p, stream_rows=4096)
    st = lgt.train(sp, lgt.Dataset(X, label=y), 3, device="cuda")
    assert type(st._gbdt).__name__ == "StreamGBDT"
    assert thist.launch_counts["hist_full"] > 3 * 30
    assert thist.launch_counts["hist_leaves"] == 0

    def structure(b):
        return [ln for ln in b.model_to_string().splitlines()
                if ln.startswith(("split_feature=", "threshold=",
                                  "left_child=", "right_child=",
                                  "leaf_count="))]
    assert structure(st) == structure(ref)
    np.testing.assert_allclose(st.predict(X), ref.predict(X), rtol=0,
                               atol=1e-5)
