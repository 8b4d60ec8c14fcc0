"""PyTorch port, the listed design of the atomic kernels' bin tiles, on the
CPU.

Where one feature's ``[B, 3]`` float64 histogram does not fit a CTA (B
above ~8,900), ``hist_full`` and ``hist_leaves`` take the listed design: a
pre-pass (``histogram.bin_lists``, the ``hist_lists`` kernel on the card)
lists, for each (feature, tile of 256 bins, slot), the rows whose bin lies
in the tile, in row order; the main kernel's warps then walk only those
rows.  Here:

- the pre-pass's plain version (``bin_lists_plain``) against a numpy
  stable partition: the counts and offsets of every segment, the row order
  inside each list, the bins' indices in their tiles, the unit table, and
  the rows it must leave out (bins >= B, rows whose three products are
  zero, blocks of no slot), on random, Zipf-skewed, one-tile and all-high
  bins, for the full pass and per slot;
- the lists add up to the plain histograms, bit for bit on values whose
  sums are exact;
- the plan's Python mirror (``atomic_geometry``, ``atomic_scratch``) at B
  = 12,000, 16,384 and 65,536: the listed design, every bin in one tile,
  no plan in the designs that hold whole features, the list bytes; and the
  widths that one tile holds keep the plan they had;
- the lists' bound: a call's features in passes sized to a budget
  (``list_passes``), one feature as the floor, and the passes' plain
  lists adding up to one pass's histograms bit for bit.


The kernels themselves, bit for bit against these plain versions, are in
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as thist

pytestmark = pytest.mark.torch_port


def _bins(rng, kind, shape, B):
    if kind == "zipf":
        p = 1.0 / np.arange(1, B + 1) ** 1.1
        return rng.choice(B, size=shape, p=p / p.sum()).astype(np.uint16)
    if kind == "one_tile":                         # every bin in tile 1
        return rng.integers(256, 512, shape).astype(np.uint16)
    if kind == "all_high":                         # every bin >= B
        return rng.integers(B, 65_536, shape).astype(np.uint16)
    b = rng.integers(0, B + 400, shape).astype(np.uint16)
    b[3] = 65_535
    return b


def _values(rng, n):
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    m = np.where(rng.random(n) < 0.2, 0.0, 1.0).astype(np.float32)
    g[5], m[5] = 0.0, 1.0                  # g*m = 0 but m = 1: listed
    h[6], m[6] = np.nan, 0.0               # h*m = NaN: listed
    m[7] = 0.0                             # all three zero: never listed
    return g, h, m


def _numpy_lists(bins, g, h, m, B, f, tw, unit, br, block_leaf, k):
    """The lists by a numpy stable partition, feature by feature."""
    n = bins.shape[0]
    T = -(-B // tw)
    slot = (np.zeros(n, np.int64) if block_leaf is None
            else np.repeat(block_leaf.astype(np.int64), br)[:n])
    ok = (slot >= 0) & (slot < k)
    gw, hw = g * m, h * m
    live = ~((m == 0) & (gw == 0) & (hw == 0))
    ids = np.full((f, n), -1, np.int64)
    lbin = np.full((f, n), -1, np.int64)
    seg_len = np.zeros((f, T * k), np.int64)
    for j in range(f):
        b = bins[:, j].astype(np.int64)
        rows = np.flatnonzero((b < B) & live & ok)
        key = (b[rows] // tw) * k + slot[rows]
        order = np.argsort(key, kind="stable")
        ids[j, :rows.size] = rows[order]
        lbin[j, :rows.size] = b[rows][order] % tw
        seg_len[j] = np.bincount(key, minlength=T * k)
    seg_off = np.arange(f)[:, None] * n + np.cumsum(seg_len, 1) - seg_len
    nu = np.where(seg_len > unit, -(-seg_len // unit), 1)
    per_feature = T * k + -(-n // unit)
    seg_ubase = (np.arange(f)[:, None] * per_feature + np.cumsum(nu, 1)
                 - nu)
    unit_seg = np.full(f * per_feature, -1, np.int64)
    for seg, (u0, cnt) in enumerate(zip(seg_ubase.ravel(), nu.ravel())):
        unit_seg[u0:u0 + cnt] = seg
    return ids, lbin, seg_len, seg_off, seg_ubase, unit_seg


# (kind, n, f, ncols, B, unit, slotted): a full pass and per-slot cases
CASES = [("random", 5003, 3, 5, 12_000, 64, False),
         ("zipf", 5003, 3, 3, 16_384, 64, False),
         ("one_tile", 2048, 2, 4, 12_000, 512, False),
         ("all_high", 1500, 2, 2, 12_000, 64, False),
         ("random", 4096, 3, 9, 12_000, 32, True),
         ("zipf", 4096, 2, 8, 65_536, 100, True)]


def _case(kind, n, f, ncols, B, slotted, seed=0):
    rng = np.random.default_rng(seed)
    bins = _bins(rng, kind, (n, ncols), B)
    g, h, m = _values(rng, n)
    if slotted:
        br, k = 256, 5
        # unsorted, with blocks of no slot (-1, k) and slot 3 never named
        bl = np.array([4, 0, -1, 2, 4, 1, 5, 0, 2, 1, 4, 0, 2, 0, 1, 4],
                      np.int32)[:n // br]
    else:
        br, k, bl = 1000, 1, None
    return bins, g, h, m, br, k, bl


@pytest.mark.parametrize("kind,n,f,ncols,B,unit,slotted", CASES)
def test_plain_lists_equal_a_numpy_stable_partition(kind, n, f, ncols, B,
                                                    unit, slotted):
    bins, g, h, m, br, k, bl = _case(kind, n, f, ncols, B, slotted)
    t = [torch.as_tensor(a) for a in (bins, g, h, m)]
    got = thist.bin_lists(*t, B, f_limit=f, tile_bins=256, unit=unit,
                          block_rows=br, num_slots=k,
                          block_leaf=None if bl is None
                          else torch.as_tensor(bl))
    ids, lbin, seg_len, seg_off, seg_ubase, unit_seg = _numpy_lists(
        bins, g, h, m, B, f, 256, unit, br, bl, k)
    assert got.tiles == -(-B // 256) and got.slots == k
    np.testing.assert_array_equal(got.seg_len.numpy(), seg_len.ravel())
    np.testing.assert_array_equal(got.seg_off.numpy(), seg_off.ravel())
    np.testing.assert_array_equal(got.seg_ubase.numpy(), seg_ubase.ravel())
    np.testing.assert_array_equal(got.unit_seg.numpy(), unit_seg)
    np.testing.assert_array_equal(got.ids.numpy(), ids.ravel())
    np.testing.assert_array_equal(got.lbin.numpy().astype(np.int64),
                                  lbin.ravel())
    # nothing listed that must not be: bins >= B, zero rows, no slot
    listed = got.ids.numpy()[got.entries().numpy()]
    assert 7 not in listed
    if kind == "random":                   # row 3: bin 65,535 everywhere
        assert 3 not in listed
    if kind == "all_high":
        assert listed.size == 0
    if slotted:
        assert not np.isin(listed // br, np.flatnonzero((bl < 0) | (bl >= k))
                           ).any()
    assert thist.lists_equal(got, got)


def _exact_values(rng, n):
    g = (rng.integers(-128, 128, n) / 64).astype(np.float32)
    h = (rng.integers(1, 32, n) / 32).astype(np.float32)
    m = rng.choice(np.array([0.0, 1.0, 2.0], np.float32), n)
    return g, h, m


@pytest.mark.parametrize("kind,slotted", [("random", False), ("zipf", False),
                                          ("random", True)])
def test_lists_add_up_to_the_plain_histograms(kind, slotted):
    """Each segment's entries, summed, are its slot's feature's bins in its
    tile: the plain histogram, bit for bit (values whose sums are exact)."""
    rng = np.random.default_rng(3)
    n, f, ncols, B = 4096, 3, 6, 12_000
    bins = _bins(rng, kind, (n, ncols), B)
    g, h, m = _exact_values(rng, n)
    br, k = (256, 4) if slotted else (1000, 1)
    bl = (rng.integers(-1, k + 1, n // br).astype(np.int32) if slotted
          else None)
    t = [torch.as_tensor(a) for a in (bins, g, h, m)]
    blt = None if bl is None else torch.as_tensor(bl)
    lists = thist.bin_lists(*t, B, f_limit=f, unit=300, block_rows=br,
                            block_leaf=blt, num_slots=k)
    vals = np.stack([g * m, h * m, m], 1).astype(np.float64)
    out = np.zeros((k, f, lists.tiles * 256, 3))
    ids, lbin = lists.ids.numpy(), lists.lbin.numpy().astype(np.int64)
    for seg, (off, cnt) in enumerate(zip(lists.seg_off.numpy(),
                                         lists.seg_len.numpy())):
        jt, s = divmod(seg, k)
        j, tile = divmod(jt, lists.tiles)
        np.add.at(out[s, j], tile * 256 + lbin[off:off + cnt],
                  vals[ids[off:off + cnt]])
    if slotted:
        ref = thist.hist_leaves_plain(*t, blt, k, B, block_rows=br,
                                      f_limit=f)
    else:
        ref = thist.hist_full_plain(*t, B, f_limit=f)[None]
    np.testing.assert_array_equal(out[..., :B, :].astype(np.float32),
                                  ref.numpy())


# (f, B, stride): the main path's rows (28 u16) and the frontier's comb
# (28 + 6) at the three bin-tiled widths of chip_smoke.py
TILED = [(28, B, stride) for B in (12_000, 16_384, 65_536)
         for stride in (28, 34)]


@pytest.mark.parametrize("f,width,stride", TILED)
def test_listed_plan_at_the_tiled_widths(f, width, stride):
    """The listed design at every bin-tiled width: tiles of 256 bins, each
    bin in exactly one, a warp's histogram and the CTA within shared
    memory; the designs that hold whole features have no plan there (one
    feature does not fit); a [256, 3] float64 partial a segment, and the
    lists' bytes stated."""
    geo = thist.atomic_geometry(f, width, stride, 2)
    assert geo["design"] == 2 and geo["fg"] == 1
    assert geo["tile_bins"] == 256 and geo["tiles"] == -(-width // 256)
    assert (geo["tiles"] - 1) * 256 < width <= geo["tiles"] * 256
    assert geo["dynamic_smem_bytes"] <= thist.SMEM_MAX_BYTES // 3
    for design in ("owned", "dealt"):          # one feature does not fit
        with pytest.raises(ValueError, match=f"no {design} plan"):
            thist.atomic_geometry(f, width, stride, 2, design)
    for kernel, units, k in (("hist_full", 1_000_000, 1),
                             ("hist_leaves", 512, 16)):
        new = thist.atomic_scratch(kernel, {**geo, "ctas_per_sm": 3,
                                            "sms": 132}, f, width, units, k)
        assert new["partial_bytes"] == f * geo["tiles"] * k * 256 * 24
        rows = units if kernel == "hist_full" else units * 512
        # ids and lbin: 6 bytes an entry, and the tables besides
        assert new["list_bytes"] >= 6 * f * rows


@pytest.mark.parametrize("rows,unit", [(1_000_000, 8192), (600_000, 4096),
                                       (262_144, 2048), (1000, 2048)])
def test_list_unit_follows_the_work_of_a_call(rows, unit):
    """Entries a unit: about one unit a warp the card holds at once (4
    CTAs of 8 warps on 132 SMs), a power of two from 2,048 to LIST_UNIT:
    the full pass of 1M x 28 takes 8,192, one frontier round's leaves
    (262,144 x 28) 2,048; the scratch reports the unit the call uses."""
    geo = thist.atomic_geometry(28, 65_536, 28, 2)
    plan = {**geo, "ctas_per_sm": 4, "sms": 132}
    assert thist.list_unit(plan, 28 * rows) == unit
    sc = thist.atomic_scratch("hist_full", plan, 28, 65_536, rows)
    assert sc["unit"] == unit and sc["ctas"] == 528


# (f, B, stride, esz): the plans widths one tile holds had before the
# listed design, which they keep: (design, fg, tile rows, tiles, bins)
ONE_TILE = {(28, 256, 28, 1): (0, 28, 384, 1, 256),
            (28, 1024, 28, 2): (1, 7, 448, 1, 1024),
            (28, 1024, 34, 2): (1, 7, 448, 1, 1024),
            (35, 2599, 35, 2): (1, 3, 320, 1, 2599),
            (28, 8192, 34, 2): (1, 1, 256, 1, 8192)}


@pytest.mark.parametrize("shape", list(ONE_TILE))
def test_one_tile_widths_keep_their_plan(shape):
    geo = thist.atomic_geometry(*shape)
    assert (geo["design"], geo["fg"], geo["tile"], geo["tiles"],
            geo["tile_bins"]) == ONE_TILE[shape]
    # the listed design is taken only where it is asked for
    listed = thist.atomic_geometry(*shape, design="listed")
    assert listed["design"] == 2 and listed["tiles"] * 256 >= shape[1]


@pytest.mark.parametrize("width", [12_000, 65_536])
def test_list_bytes_grow_with_the_pairs_of_a_call(width):
    """The lists of a full pass take a fixed number of bytes a (row,
    feature) pair, as ``hist_lists.cu`` states: ids 4, lbin 2, the
    pre-pass's staging 4, the count tables 8 T / 4,096 and gh4 16 a row;
    twice the rows, twice the bytes."""
    geo = thist.atomic_geometry(28, width, 28, 2)
    plan = {**geo, "ctas_per_sm": 4, "sms": 132}
    one = thist.atomic_scratch("hist_full", plan, 28, width, 1_048_576)
    two = thist.atomic_scratch("hist_full", plan, 28, width, 2_097_152)
    per_pair = 4 + 2 + 4 + 8 * geo["tiles"] / 4096 + 16 / 28
    assert 10.6 < per_pair < 11.1
    assert one["list_bytes"] / (28 * 1_048_576) == pytest.approx(per_pair,
                                                                 abs=0.02)
    assert two["list_bytes"] == pytest.approx(2 * one["list_bytes"],
                                              rel=1e-3)


def test_lists_the_card_cannot_hold_raise_what_they_take(monkeypatch):
    """A pass of one feature whose lists' buffer cannot be allocated
    raises an OutOfMemoryError naming the lists' bytes and bytes a row, not
    the allocator's bare message; a pass of several features passes the
    allocator's error on, so that the call takes fewer a pass."""
    def refuse(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(thist.torch, "empty", refuse)
    with pytest.raises(torch.OutOfMemoryError,
                       match=r"one feature's lists of 1000 rows take "
                             r"11100 bytes \(11.1 a row\)"):
        thist._list_buffer(11_100, torch.device("cpu"), 1000, 1)
    with pytest.raises(torch.OutOfMemoryError, match=r"^CUDA out of memory$"):
        thist._list_buffer(310_000, torch.device("cpu"), 1000, 28)


# (rows, slots, chunk rows): the full pass's chunks and one round's
# leaves in 512-row blocks
PASS_SHAPES = [(200_003, 1, thist.list_chunk_rows(None)),
               (262_144, 16, thist.list_chunk_rows(512))]


@pytest.mark.parametrize("rows,k,cr", PASS_SHAPES)
def test_list_passes_fit_a_forced_budget(rows, k, cr):
    """A listed call of 28 features at B = 12,000 in passes sized to a
    budget (``list_passes``): one pass where its lists fit; below that the
    fewest passes whose buffers (``list_pass_bytes``) each fit, every
    feature in one of them, in order, their sizes at most one apart; one
    feature a pass as the floor, and a budget below one feature's lists an
    OutOfMemoryError that names them."""
    f = 28
    plan = {**thist.atomic_geometry(f, 12_000, f + 6, 2), "ctas_per_sm": 3,
            "sms": 132, "threads": 256}
    one = thist.list_pass_bytes(plan, f, rows, k, cr)
    assert thist.list_passes(plan, f, rows, k, cr, one) == [(0, f)]
    for share in (2, 4, 7):
        budget = one // share
        passes = thist.list_passes(plan, f, rows, k, cr, budget)
        sizes = [fp for _, fp in passes]
        assert [f0 for f0, _ in passes] == [sum(sizes[:i])
                                            for i in range(len(sizes))]
        assert sum(sizes) == f and max(sizes) - min(sizes) <= 1
        assert all(thist.list_pass_bytes(plan, fp, rows, k, cr) <= budget
                   for fp in sizes)
        widest = max(fp for fp in range(1, f + 1)
                     if thist.list_pass_bytes(plan, fp, rows, k, cr)
                     <= budget)
        assert len(passes) == -(-f // widest) >= share
    floor = thist.list_pass_bytes(plan, 1, rows, k, cr)
    assert thist.list_passes(plan, f, rows, k, cr, floor) == [
        (j, 1) for j in range(f)]
    with pytest.raises(torch.OutOfMemoryError,
                       match=f"one feature's lists of {rows} rows take "
                             f"{floor} bytes"):
        thist.list_passes(plan, f, rows, k, cr, floor - 1)


@pytest.mark.parametrize("f", (28, 35, 5))
def test_a_failed_pass_halves_it_and_the_rest(f):
    """A pass that fails to allocate (``halve_passes``): the passes before
    it stay, it and the rest go in passes of at most half its features,
    every feature in one pass, in order, their sizes at most one apart;
    halving again ends at one feature a pass."""
    passes = [(0, f)]
    at, seen = 0, []
    while any(fp > 1 for _, fp in passes):
        at = next(i for i, (_, fp) in enumerate(passes) if fp > 1)
        head, width = passes[:at], passes[at][1]
        passes = thist.halve_passes(passes, at)
        assert passes[:at] == head
        rest = [fp for _, fp in passes[at:]]
        assert max(rest) <= width // 2 and max(rest) - min(rest) <= 1
        assert [f0 for f0, _ in passes] == [
            sum(fp for _, fp in passes[:i]) for i in range(len(passes))]
        assert sum(fp for _, fp in passes) == f
        seen.append(len(passes))
    assert passes == [(j, 1) for j in range(f)]
    assert seen == sorted(seen)
    assert thist.even_passes(3, 10, 3) == [(3, 3), (6, 2), (8, 2)]


def _hist_of(lists, vals, k, f):
    """The float64 histograms [k, f, T * tw, 3] the lists' entries add up
    to, each entry in list order."""
    tw = lists.tile_bins
    out = np.zeros((k, f, lists.tiles * tw, 3))
    ids, lbin = lists.ids.numpy(), lists.lbin.numpy().astype(np.int64)
    for seg, (off, cnt) in enumerate(zip(lists.seg_off.numpy(),
                                         lists.seg_len.numpy())):
        jt, s = divmod(seg, k)
        j, tile = divmod(jt, lists.tiles)
        np.add.at(out[s, j], tile * tw + lbin[off:off + cnt],
                  vals[ids[off:off + cnt]])
    return out


@pytest.mark.parametrize("slotted", (False, True))
def test_feature_passes_add_up_to_one_pass_bit_for_bit(slotted):
    """The passes of a call held to half its lists' bytes: each pass's
    plain lists (``bin_lists`` from its first column) are the one pass's
    lists of those features, and the histograms they add up to, side by
    side, are the one pass's bit for bit."""
    rng = np.random.default_rng(5)
    n, f, ncols, B = 4096, 5, 7, 12_000
    bins = _bins(rng, "zipf", (n, ncols), B)
    g, h, m = _values(rng, n)
    br, k = (256, 4) if slotted else (thist.list_chunk_rows(None), 1)
    bl = (torch.as_tensor(rng.integers(-1, k + 1, n // br).astype(np.int32))
          if slotted else None)
    t = [torch.as_tensor(a) for a in (bins, g, h, m)]
    kw = dict(unit=300, block_rows=br, block_leaf=bl, num_slots=k)
    one = thist.bin_lists(*t, B, f_limit=f, **kw)
    plan = {**thist.atomic_geometry(f, B, ncols, 2), "ctas_per_sm": 3,
            "sms": 132, "threads": 256}
    cr = br if not slotted else thist.list_chunk_rows(br)
    passes = thist.list_passes(plan, f, n, k, cr, thist.list_pass_bytes(
        plan, f, n, k, cr) // 2)
    assert len(passes) >= 2
    vals = np.stack([g * m, h * m, m], 1).astype(np.float64)
    whole = _hist_of(one, vals, k, f)
    parts = []
    for f0, fp in passes:
        lst = thist.bin_lists(*t, B, f_limit=fp, col0=f0, **kw)
        for name in ("ids", "lbin"):
            np.testing.assert_array_equal(
                getattr(lst, name).numpy().reshape(fp, n),
                getattr(one, name).numpy().reshape(f, n)[f0:f0 + fp])
        np.testing.assert_array_equal(
            lst.seg_len.numpy().reshape(fp, -1),
            one.seg_len.numpy().reshape(f, -1)[f0:f0 + fp])
        parts.append(_hist_of(lst, vals, k, fp))
    got = np.concatenate(parts, axis=1)
    assert np.array_equal(got.view(np.int64), whole.view(np.int64))
