"""Best-split search over histograms.

Port of the JAX package's ``ops/split.py``
(``find_best_split``): vectorized cumulative sums over the whole ``[F, B]``
histogram, both missing-value directions evaluated as two cumsum variants,
leaf output / gain closed forms with L1, L2, ``max_delta_step`` and path
smoothing, and the ``min_data_in_leaf`` / ``min_sum_hessian_in_leaf`` /
``min_gain_to_split`` gates; monotone-basic (candidates whose child outputs
violate the feature's direction are rejected, leaf outputs clamped to the
leaf's bounds), extra-trees (one random threshold per feature) and the
monotone split penalty (``gain_mult``); categorical features by one-hot
splits (``bin == t`` goes left, up to ``max_cat_to_onehot`` bins) and by the
sorted many-category scan (``_sorted_cat_best``: bins ordered by
``sum_g / (sum_h + cat_smooth)``, prefixes from both ends), each split
carrying the bitset of the bins that go left.  The arithmetic runs in
float32 in the same order as the JAX code, so both packages pick the same
split wherever the best gain is not a near-tie.

Everything is batched over a leading dimension: ``hist [S, F, B, 3]`` and
totals ``[S]`` give an ``[S]``-batched ``SplitResult`` (the frontier's 2k
child searches in one call; the JAX package ``vmap``s the same function).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30
POS_INF = 1e30


class SplitParams(NamedTuple):
    """Gain-formula parameters (subset of Config)."""
    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    min_gain_to_split: float
    max_delta_step: float
    path_smooth: float
    cat_smooth: float
    cat_l2: float
    max_cat_to_onehot: int
    max_cat_threshold: int = 32
    min_data_per_group: int = 100


class SplitResult(NamedTuple):
    """Best split of one leaf (or a batch of leaves) — the analog of
    ``SplitInfo``, ``src/treelearner/split_info.hpp:51``."""
    gain: torch.Tensor          # f32 — improvement over parent (NEG_INF if none)
    feature: torch.Tensor       # i32 inner feature index
    threshold: torch.Tensor     # i32 bin threshold (<=: left)
    default_left: torch.Tensor  # bool — missing goes left
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor    # f32 (weighted count)
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    cat_bits: torch.Tensor      # [.., CW] i32, zeros for numerical splits


def cat_words(b: int) -> int:
    """Bitset words needed for ``b`` bins."""
    return max(1, -(-b // 32))


def pack_bin_bitset(member: torch.Tensor) -> torch.Tensor:
    """Pack a ``[..., B]`` membership mask into ``[..., ceil(B/32)]``
    int32 words (bit ``b % 32`` of word ``b // 32``)."""
    b = member.shape[-1]
    cw = cat_words(b)
    pad = cw * 32 - b
    if pad:
        member = torch.nn.functional.pad(member, (0, pad))
    m = member.reshape(member.shape[:-1] + (cw, 32)).long()
    shifts = torch.arange(32, dtype=torch.int64, device=member.device)
    packed = (m << shifts).sum(-1)                       # < 2**32
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


def bitset_contains(bits: torch.Tensor, idx: torch.Tensor,
                    which: torch.Tensor = None) -> torch.Tensor:
    """Whether bit ``idx`` is set, per entry of ``idx`` (int64, >= 0): in
    the bitset ``bits [CW]`` (int32 words), or with ``which`` in bitset
    ``which`` of ``bits [K, CW]`` (a word past the last reads the last, as
    the JAX version's clipped ``take``)."""
    w = torch.clamp(idx >> 5, max=bits.shape[-1] - 1)
    word = bits.long()[w] if which is None else bits.long()[which, w]
    return ((word >> (idx & 31)) & 1) == 1


def threshold_l1(s, l1):
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(sum_g, sum_h, p: SplitParams, parent_output=0.0, count=None,
                lo=None, hi=None):
    """Closed-form leaf output with L1/L2/max_delta_step/path smoothing and
    optional output bounds (reference ``CalculateSplittedLeafOutput``)."""
    raw = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + p.lambda_l2 + 1e-35)
    if p.max_delta_step > 0:
        raw = torch.clamp(raw, -p.max_delta_step, p.max_delta_step)
    if p.path_smooth > 0 and count is not None:
        smooth = count / (count + p.path_smooth)
        raw = raw * smooth + parent_output * (1.0 - smooth)
    if lo is not None:
        raw = torch.clamp(raw, lo, hi)
    return raw


def leaf_gain_given_output(sum_g, sum_h, out, p: SplitParams):
    """Reference ``GetLeafGainGivenOutput``: -(2·G̃·w + (H+λ₂)·w²)."""
    g1 = threshold_l1(sum_g, p.lambda_l1)
    return -(2.0 * g1 * out + (sum_h + p.lambda_l2) * out * out)


def leaf_gain(sum_g, sum_h, p: SplitParams, parent_output=0.0, count=None,
              lo=None, hi=None):
    if p.max_delta_step > 0 or p.path_smooth > 0 or lo is not None:
        out = leaf_output(sum_g, sum_h, p, parent_output, count, lo, hi)
        return leaf_gain_given_output(sum_g, sum_h, out, p)
    g1 = threshold_l1(sum_g, p.lambda_l1)
    return g1 * g1 / (sum_h + p.lambda_l2 + 1e-35)


def _gain_at(left, right, p: SplitParams, valid, lo, hi, mono):
    """Candidate gains ``[S, F, B]`` of (left, right) sums ``[S, F, B, 3]``;
    ``mono [1, F, 1]`` (or None) rejects direction violations (the JAX
    ``_gain_at``'s monotone-basic check)."""
    gl, hl, cl = left[..., 0], left[..., 1], left[..., 2]
    gr, hr, cr = right[..., 0], right[..., 1], right[..., 2]
    # the port always passes bounds, so leaf_gain takes its output form:
    # one leaf_output per side serves the gain and the monotone check
    lo_o = leaf_output(gl, hl, p, 0.0, cl, lo, hi)
    ro_o = leaf_output(gr, hr, p, 0.0, cr, lo, hi)
    gain = (leaf_gain_given_output(gl, hl, lo_o, p)
            + leaf_gain_given_output(gr, hr, ro_o, p))
    ok = (valid
          & (cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
          & (hl >= p.min_sum_hessian_in_leaf) & (hr >= p.min_sum_hessian_in_leaf))
    if mono is not None:
        bad = ((mono > 0) & (lo_o > ro_o)) | ((mono < 0) & (lo_o < ro_o))
        ok = ok & ~bad
    return torch.where(ok, gain, torch.full_like(gain, NEG_INF))


def _per_leaf(v, dev):
    """A bound given as a float stays one; an ``[S]`` tensor becomes
    ``([S], [S, 1, 1])`` views for the per-leaf and per-candidate math."""
    if isinstance(v, torch.Tensor):
        v = v.to(dev, torch.float32)
        return v, v[:, None, None]
    return v, v


def _sorted_cat_best(hist, num_bins, cat_feats, mono, total, p: SplitParams,
                     fmask, lo, hi, contri=None, penalty=None):
    """The sorted many-category scan (the JAX ``_sorted_cat_best``,
    reference ``FindBestThresholdCategoricalInner`` sorted branch,
    feature_histogram.hpp:378-474) over the categorical features
    ``cat_feats [Fc]`` of every leaf: bins with at least ``cat_smooth``
    rows sorted by ``sum_g / (sum_h + cat_smooth)``, prefixes of up to
    ``min(max_cat_threshold, (used + 1) / 2)`` bins from both ends as the
    left set, ``min_data_per_group`` gating the prefixes.

    ``hist [S, F, B, 3]``, ``total [S, 3]``, ``fmask [S, F]``, ``mono
    [F]`` or None, ``lo``/``hi`` floats or ``[S]``.  Returns ``(gain [S,
    F], bits [S, F, CW], left [S, F, 3])``; features outside ``cat_feats``
    (or not wider than ``max_cat_to_onehot``) have gain ``NEG_INF``.
    ``contri`` and ``penalty`` (``[S, F]`` or None) scale, then lower, each
    prefix's gain as in the grid search."""
    s_, f, b, _ = hist.shape
    dev = hist.device
    cw = cat_words(b)
    gain_out = torch.full((s_, f), NEG_INF, dtype=torch.float32, device=dev)
    bits_out = torch.zeros(s_, f, cw, dtype=torch.int32, device=dev)
    left_out = torch.zeros(s_, f, 3, dtype=torch.float32, device=dev)
    if cat_feats.numel() == 0:
        return gain_out, bits_out, left_out
    maxT = max(1, min(p.max_cat_threshold, b))
    hc = hist[:, cat_feats]                                      # [S, Fc, B, 3]
    g, h, c = hc[..., 0], hc[..., 1], hc[..., 2]
    nb = num_bins[cat_feats].to(torch.int64)                     # [Fc]
    bin_ids = torch.arange(b, device=dev)[None, None, :]
    active = ((nb > p.max_cat_to_onehot)[None, :]
              & (fmask[:, cat_feats] > 0))                       # [S, Fc]
    elig = ((c >= p.cat_smooth) & (bin_ids >= 1)
            & (bin_ids < nb[None, :, None]))                     # [S, Fc, B]
    used_bin = elig.sum(-1)                                      # [S, Fc]
    max_num_cat = torch.clamp((used_bin + 1) // 2, max=p.max_cat_threshold)
    inf = torch.tensor(float("inf"), device=dev)
    score = torch.where(elig, g / (h + p.cat_smooth), inf)
    p_eff = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
    mono_c = (mono.to(dev)[cat_feats][None, :] if mono is not None
              else torch.zeros(1, cat_feats.numel(), dtype=torch.int8,
                               device=dev))
    lo2 = lo[:, None] if isinstance(lo, torch.Tensor) else lo
    hi2 = hi[:, None] if isinstance(hi, torch.Tensor) else hi
    tg, th, tc = (total[:, i:i + 1] for i in range(3))           # [S, 1]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nc = cat_feats.numel()
    if contri is not None:
        pivot = (leaf_gain(tg, th, p, 0.0, tc, lo2, hi2)
                 + p.min_gain_to_split)[..., None]               # [S, 1, 1]
        contri_c = contri[:, cat_feats, None]
    if penalty is not None:
        pen_c = penalty[:, cat_feats, None]

    def scan_dir(order_score):
        idx = torch.sort(order_score, dim=-1, stable=True).indices  # [S, Fc, B]

        def tk(a):
            return torch.gather(torch.where(elig, a, zero), -1, idx)
        # every prefix length at once: left sums [S, Fc, T] of the first
        # i + 1 sorted bins, T = min(maxT, B)
        lg = torch.cumsum(tk(g), -1)[..., :maxT]
        lh = torch.cumsum(tk(h), -1)[..., :maxT] + 1e-15          # kEpsilon
        lc = torch.cumsum(tk(c), -1)[..., :maxT]
        sc_step = tk(c)[..., :maxT]
        T = lg.shape[-1]
        rg, rh, rc = tg[..., None] - lg, th[..., None] - lh, tc[..., None] - lc
        in_range = (torch.arange(T, device=dev)
                    < torch.minimum(used_bin, max_num_cat)[..., None])
        gate1 = (lc >= p.min_data_in_leaf) & (lh >= p.min_sum_hessian_in_leaf)
        nobrk = ((rc >= p.min_data_in_leaf) & (rc >= p.min_data_per_group)
                 & (rh >= p.min_sum_hessian_in_leaf))
        ok = in_range & gate1 & nobrk
        # the one sequential part: the group count since the last taken
        # prefix (min_data_per_group), reset where a prefix is taken
        cnt_grp = torch.zeros_like(tg.expand(s_, nc))
        taken = []
        for i in range(T):
            cnt_grp = cnt_grp + sc_step[..., i]
            t_i = ok[..., i] & (cnt_grp >= p.min_data_per_group)
            cnt_grp = torch.where(t_i, zero, cnt_grp)
            taken.append(t_i)
        considered = active[..., None] & torch.stack(taken, -1)
        lo3, hi3 = lo2, hi2
        if isinstance(lo2, torch.Tensor):
            lo3, hi3 = lo2[..., None], hi2[..., None]
        lo_out = leaf_output(lg, lh, p_eff, 0.0, lc, lo3, hi3)
        ro_out = leaf_output(rg, rh, p_eff, 0.0, rc, lo3, hi3)
        mono3 = mono_c[..., None]
        bad = (((mono3 > 0) & (lo_out > ro_out))
               | ((mono3 < 0) & (lo_out < ro_out)))
        raw = (leaf_gain(lg, lh, p_eff, 0.0, lc, lo3, hi3)
               + leaf_gain(rg, rh, p_eff, 0.0, rc, lo3, hi3))
        if contri is not None:
            raw = pivot + (raw - pivot) * contri_c
        if penalty is not None:
            raw = raw - pen_c
        gain = torch.where(considered & ~bad, raw,
                           torch.full_like(raw, NEG_INF))
        # the first prefix of the largest gain (the sequential scan keeps
        # a strictly better one); none: NEG_INF at prefix 0
        best_i = torch.argmax(gain, -1)
        best_gain = torch.gather(gain, -1, best_i[..., None])[..., 0]
        return best_gain, best_i, idx

    g_asc, i_asc, idx_asc = scan_dir(score)
    g_dsc, i_dsc, idx_dsc = scan_dir(torch.where(elig, -score, inf))
    use_dsc = g_dsc > g_asc
    best_gain = torch.where(use_dsc, g_dsc, g_asc)
    best_i = torch.where(use_dsc, i_dsc, i_asc)
    idx = torch.where(use_dsc[..., None], idx_dsc, idx_asc)
    memb_sorted = bin_ids <= best_i[..., None]                   # [S, Fc, B]
    memb = torch.zeros_like(memb_sorted).scatter_(-1, idx, memb_sorted)
    left = torch.where(memb[..., None], hc, zero).sum(2)         # [S, Fc, 3]
    gain_out[:, cat_feats] = best_gain
    bits_out[:, cat_feats] = pack_bin_bitset(memb)
    left_out[:, cat_feats] = left
    return gain_out, bits_out, left_out


class _Grid(NamedTuple):
    """The candidate gains of a batched search, before the monotone split
    penalty: ``gain [S, F, B]`` and what the winner's sums are read from."""
    gain: torch.Tensor
    use_left: torch.Tensor
    cum: torch.Tensor
    miss: torch.Tensor
    total: torch.Tensor           # [S, 3]
    lo1: object
    hi1: object
    is_cat: object                # [F] bool, or None
    sorted: object                # (gain [S, F], bits, left) or None


def _candidate_gains(hist, num_bins, nan_bins, sum_g, sum_h, count, p,
                     feature_mask, output_lo, output_hi, monotone,
                     rand_threshold, is_categorical, sorted_cat, contri,
                     gain_penalty) -> _Grid:
    """Every candidate's gain (``find_best_split``'s arguments; the JAX
    package's ``_split_gain_matrix`` and sorted scan)."""
    s_, f, b, _ = hist.shape
    dev = hist.device
    total = torch.stack([torch.as_tensor(sum_g, dtype=torch.float32),
                         torch.as_tensor(sum_h, dtype=torch.float32),
                         torch.as_tensor(count, dtype=torch.float32)],
                        dim=-1).to(dev)                                # [S, 3]
    bin_ids = torch.arange(b, dtype=torch.int32, device=dev)[None, :]  # [1, B]
    lo1, lo3 = _per_leaf(output_lo, dev)
    hi1, hi3 = _per_leaf(output_hi, dev)
    mono = (monotone.to(dev)[None, :, None] if monotone is not None
            else None)

    # the missing bin (trailing NaN bin, or the zero bin for
    # zero_as_missing) is excluded from the ordered sweep and trialed on
    # both sides
    miss_bin = nan_bins.to(torch.int32)
    has_miss = miss_bin >= 0
    miss_sel = (bin_ids == miss_bin[:, None]) & has_miss[:, None]      # [F, B]
    ms4 = miss_sel[None, :, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    miss = torch.where(ms4, hist, zero).sum(dim=2)                     # [S, F, 3]
    swept = torch.where(ms4, zero, hist)
    cum = torch.cumsum(swept, dim=2)                                   # [S, F, B, 3]

    # threshold t: bins <= t go left (t in [0, num_bin-2]); a TRAILING
    # missing bin removes the last real threshold with it
    trailing_miss = has_miss & (miss_bin == num_bins - 1)
    valid_t = bin_ids < (num_bins[:, None] - 1 - trailing_miss[:, None].int())
    tot4 = total[:, None, None, :]

    right_r = tot4 - cum
    gain_r = _gain_at(cum, right_r, p, valid_t, lo3, hi3, mono)        # missing -> right
    left_l = cum + miss[:, :, None, :]
    gain_l = _gain_at(left_l, tot4 - left_l, p, valid_t, lo3, hi3,
                      mono)                                            # missing -> left
    # features without a missing bin add zero: identical to the right sweep
    gain_l = torch.where(has_miss[None, :, None], gain_l, gain_r)
    use_left = gain_l > gain_r
    gain_fb = torch.where(use_left, gain_l, gain_r)                    # [S, F, B]
    p_cat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
    if is_categorical is not None:
        # one-hot: left = (bin == t) for features of at most
        # max_cat_to_onehot bins; bin 0 (the unseen/other/NaN catch-all)
        # is never a left set
        is_cat = is_categorical.to(dev)
        cat_valid = ((bin_ids >= 1) & (bin_ids < num_bins[:, None])
                     & (num_bins[:, None] <= p.max_cat_to_onehot))
        cat_gain = _gain_at(hist, tot4 - hist, p_cat, cat_valid, lo3, hi3,
                            mono)
        gain_fb = torch.where(is_cat[None, :, None], cat_gain, gain_fb)
    if contri is not None:
        # feature_contri scales the min-gain-shifted improvement BEFORE the
        # CEGB penalty is subtracted (the JAX _split_gain_matrix order,
        # reference feature_histogram.hpp:94 then
        # serial_tree_learner.cpp:740)
        contri = contri.to(dev).expand(s_, f)
        pivot = (leaf_gain(total[:, 0], total[:, 1], p, 0.0, total[:, 2],
                           lo1, hi1) + p.min_gain_to_split)[:, None, None]
        gain_fb = torch.where(gain_fb > NEG_INF / 2,
                              pivot + (gain_fb - pivot) * contri[:, :, None],
                              gain_fb)
    if gain_penalty is not None:
        gain_penalty = gain_penalty.to(dev).expand(s_, f)
        gain_fb = torch.where(gain_fb > NEG_INF / 2,
                              gain_fb - gain_penalty[:, :, None], gain_fb)
    neg = torch.full_like(gain_fb, NEG_INF)
    if rand_threshold is not None:
        # extra_trees: each feature offers exactly ONE random threshold;
        # categorical features keep the full scan
        keep = bin_ids[None] == rand_threshold.to(dev)[:, :, None]
        if is_categorical is not None:
            keep = keep | is_cat[None, :, None]
        gain_fb = torch.where(keep, gain_fb, neg)
    fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    gain_fb = torch.where(fm[:, :, None] > 0, gain_fb, neg)
    srt = None
    if sorted_cat is not None and sorted_cat.numel() > 0:
        srt = _sorted_cat_best(
            hist, num_bins, sorted_cat.to(dev), monotone, total, p,
            fm.expand(s_, f), output_lo, output_hi, contri=contri,
            penalty=gain_penalty)
    return _Grid(gain_fb, use_left, cum, miss, total, lo1, hi1,
                 is_cat if is_categorical is not None else None, srt)


def find_best_split(hist: torch.Tensor, num_bins: torch.Tensor,
                    nan_bins: torch.Tensor, sum_g, sum_h, count,
                    p: SplitParams, feature_mask: torch.Tensor,
                    output_lo=NEG_INF, output_hi=POS_INF,
                    monotone: torch.Tensor = None,
                    rand_threshold: torch.Tensor = None,
                    gain_mult: torch.Tensor = None,
                    is_categorical: torch.Tensor = None,
                    sorted_cat: torch.Tensor = None,
                    contri: torch.Tensor = None,
                    gain_penalty: torch.Tensor = None) -> SplitResult:
    """Best split of each leaf of a batch.

    Args:
      hist: ``[S, F, B, 3]`` (grad, hess, count) histograms.
      num_bins/nan_bins: ``[F]`` int32 feature metadata (``nan_bins`` is the
        missing bin per feature, or -1).
      sum_g/sum_h/count: ``[S]`` leaf totals.
      feature_mask: ``[F]`` or per leaf ``[S, F]`` f32 — 0 excludes a
        feature.
      output_lo/output_hi: monotone output bounds, floats or ``[S]``.
      monotone: ``[F]`` -1/0/+1 directions (None: no constraint).
      rand_threshold: ``[S, F]`` extra-trees threshold per feature (the
        only one each feature offers), or None.
      gain_mult: ``[S, F]`` monotone split penalty factors, or None.
      is_categorical: ``[F]`` bool (None: every feature numerical); a
        categorical feature offers the one-hot splits ``bin == t`` when it
        has at most ``max_cat_to_onehot`` bins.
      sorted_cat: ``[Fc]`` int64, the categorical features that take the
        sorted many-category scan (more than ``max_cat_to_onehot`` bins),
        or None when there are none (the JAX ``sorted_cat`` static).
      contri: ``[F]`` or ``[S, F]`` ``feature_contri`` multipliers of the
        min-gain-shifted improvement, or None.
      gain_penalty: ``[S, F]`` CEGB penalties subtracted from every
        candidate of a feature after ``contri``, or None.
    Returns an ``[S]``-batched ``SplitResult``.
    """
    s_, f, b, _ = hist.shape
    dev = hist.device
    grid = _candidate_gains(hist, num_bins, nan_bins, sum_g, sum_h, count, p,
                            feature_mask, output_lo, output_hi, monotone,
                            rand_threshold, is_categorical, sorted_cat,
                            contri, gain_penalty)
    gain_fb, use_left, cum, miss, total, lo1, hi1, is_cat, srt = grid
    use_sc = srt is not None
    if use_sc:
        gain_sorted, bits_sorted, left_sorted = srt
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p_cat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
    if gain_mult is not None:
        # monotone split penalty, rebased around parent gain + min_gain so
        # that the reported improvement is the reference's scaled gain
        pivot = (leaf_gain(total[:, 0], total[:, 1], p, 0.0, total[:, 2],
                           lo1, hi1) + p.min_gain_to_split)[:, None]
        gain_fb = torch.where(gain_fb > NEG_INF / 2,
                              pivot[..., None]
                              + (gain_fb - pivot[..., None])
                              * gain_mult[:, :, None],
                              gain_fb)
        if use_sc:
            gain_sorted = torch.where(
                gain_sorted > NEG_INF / 2,
                pivot + (gain_sorted - pivot) * gain_mult, gain_sorted)

    flat = gain_fb.reshape(s_, f * b)
    best_idx = torch.argmax(flat, dim=1)                               # [S]
    best_gain = flat.gather(1, best_idx[:, None])[:, 0]
    best_f = (best_idx // b).to(torch.int32)
    best_t = (best_idx % b).to(torch.int32)
    rows = torch.arange(s_, device=dev)
    bf_missing_left = use_left.reshape(s_, f * b)[rows, best_idx]

    left = cum.reshape(s_, f * b, 3)[rows, best_idx]                   # [S, 3]
    left = left + torch.where(bf_missing_left[:, None],
                              miss[rows, best_f.long()], zero)
    cat_bits = torch.zeros(s_, cat_words(b), dtype=torch.int32, device=dev)
    if is_categorical is not None:
        if use_sc:
            # the sorted subsets compete per feature: the first feature of
            # the largest sorted gain, where it beats the grid's best
            sorted_f = torch.argmax(gain_sorted, dim=1)                # [S]
            g_sf = gain_sorted[rows, sorted_f]
            use_sorted = g_sf > best_gain
            best_gain = torch.where(use_sorted, g_sf, best_gain)
            best_f = torch.where(use_sorted, sorted_f.to(torch.int32), best_f)
            best_t = torch.where(use_sorted, torch.zeros_like(best_t), best_t)
        bf_cat = is_cat[best_f.long()]
        bf_missing_left = bf_missing_left & ~bf_cat
        onehot_bits = pack_bin_bitset(
            torch.arange(b, device=dev)[None, :] == best_t[:, None].long())
        cat_bits = torch.where(bf_cat[:, None], onehot_bits, cat_bits)
        left_cat = hist.reshape(s_, f * b, 3)[rows, best_idx]
        left = torch.where(bf_cat[:, None], left_cat, left)
        if use_sc:
            cat_bits = torch.where(use_sorted[:, None],
                                   bits_sorted[rows, sorted_f], cat_bits)
            left = torch.where(use_sorted[:, None],
                               left_sorted[rows, sorted_f], left)
    right = total - left
    lo_out = leaf_output(left[:, 0], left[:, 1], p, 0.0, left[:, 2],
                         lo1, hi1)
    hi_out = leaf_output(right[:, 0], right[:, 1], p, 0.0, right[:, 2],
                         lo1, hi1)
    if is_categorical is not None:
        # categorical outputs take the categorical L2 (the reference's
        # CalculateSplittedLeafOutput with l2 += cat_l2)
        lo_out = torch.where(bf_cat, leaf_output(
            left[:, 0], left[:, 1], p_cat, 0.0, left[:, 2], lo1, hi1), lo_out)
        hi_out = torch.where(bf_cat, leaf_output(
            right[:, 0], right[:, 1], p_cat, 0.0, right[:, 2], lo1, hi1),
            hi_out)

    # parent gain baseline: reported gain is improvement over parent
    parent_gain = leaf_gain(total[:, 0], total[:, 1], p, 0.0, total[:, 2],
                            lo1, hi1)
    improvement = best_gain - parent_gain - p.min_gain_to_split
    ok = improvement > 0.0
    return SplitResult(
        gain=torch.where(ok, improvement + p.min_gain_to_split,
                         torch.full_like(improvement, NEG_INF)),
        feature=best_f,
        threshold=best_t,
        default_left=bf_missing_left,
        left_sum_g=left[:, 0], left_sum_h=left[:, 1], left_count=left[:, 2],
        right_sum_g=right[:, 0], right_sum_h=right[:, 1],
        right_count=right[:, 2],
        left_output=lo_out, right_output=hi_out,
        cat_bits=cat_bits,
    )


def per_feature_gains(hist, num_bins, nan_bins, sum_g, sum_h, count,
                      p: SplitParams, feature_mask, output_lo=NEG_INF,
                      output_hi=POS_INF, monotone=None, gain_mult=None,
                      is_categorical=None, sorted_cat=None,
                      contri=None) -> torch.Tensor:
    """The best candidate gain of each feature, ``[S, F]`` (the JAX
    package's ``per_feature_gains``): the voting learner's local proposal
    (reference ``VotingParallelTreeLearner``,
    voting_parallel_tree_learner.cpp:151).  The gains carry ``contri`` and
    the monotone penalty ``gain_mult``, as the reference votes on
    penalized SplitInfo gains; no CEGB penalty and no extra-trees
    threshold, as in the JAX package."""
    grid = _candidate_gains(hist, num_bins, nan_bins, sum_g, sum_h, count, p,
                            feature_mask, output_lo, output_hi, monotone,
                            None, is_categorical, sorted_cat, contri, None)
    best = grid.gain.max(dim=2).values                           # [S, F]
    if grid.sorted is not None:
        best = torch.maximum(best, grid.sorted[0])
    if gain_mult is not None:
        t = grid.total
        pivot = (leaf_gain(t[:, 0], t[:, 1], p, 0.0, t[:, 2], grid.lo1,
                           grid.hi1) + p.min_gain_to_split)[:, None]
        best = torch.where(best > NEG_INF / 2,
                           pivot + (best - pivot) * gain_mult, best)
    return best


def voting_elect(hist, num_bins, nan_bins, sum_g, sum_h, count,
                 p: SplitParams, feature_mask, mesh, top_k: int,
                 num_shards: int, output_lo=NEG_INF, output_hi=POS_INF,
                 monotone=None, gain_mult=None, is_categorical=None,
                 sorted_cat=None, contri=None):
    """The voting-parallel election (the JAX package's ``voting_elect``,
    reference voting_parallel_tree_learner.cpp:151-345) over a batch of
    leaves: each rank proposes its ``top_k`` features by local gains under
    the min-data/min-hessian gates scaled by ``1 / num_shards`` (``:61-63``),
    the ballots are one-hot votes summed over the ranks, the ``2 top_k``
    features of the most votes are elected (the lower index wins a tie),
    and only their histograms are summed over the ranks.  Returns
    ``(hist_elected [S, F, B, 3], elected_mask [S, F])`` for the caller's
    final ``find_best_split``.  ``hist`` is this rank's ``[S, F, B, 3]``;
    ``sum_g``/``sum_h``/``count`` are the global totals; ``mesh`` is the
    ranks' ``parallel.mesh.ProcessMesh``."""
    ns = max(1, num_shards)
    s_, f_full = hist.shape[0], hist.shape[1]
    dev = hist.device
    p_loc = p._replace(
        min_data_in_leaf=max(1, p.min_data_in_leaf // ns),
        min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf / ns)
    t = [torch.as_tensor(v, dtype=torch.float32).to(dev) / ns
         for v in (sum_g, sum_h, count)]
    fg = per_feature_gains(hist, num_bins, nan_bins, *t, p_loc, feature_mask,
                           output_lo, output_hi, monotone=monotone,
                           gain_mult=gain_mult, is_categorical=is_categorical,
                           sorted_cat=sorted_cat, contri=contri)  # [S, F]
    kv = min(top_k, f_full)
    # lax.top_k: the lower index first among equal gains
    top = torch.sort(fg, dim=1, descending=True, stable=True)
    topv, topi = top.values[:, :kv], top.indices[:, :kv]
    votes = torch.zeros(s_, f_full, dtype=torch.float32, device=dev)
    votes.scatter_add_(1, topi, (topv > NEG_INF / 2).to(torch.float32))
    votes = mesh.all_reduce(votes)
    score = votes * (f_full + 1.0) - torch.arange(
        f_full, dtype=torch.float32, device=dev)
    k2 = min(2 * kv, f_full)
    elected = torch.sort(score, dim=1, descending=True,
                         stable=True).indices[:, :k2]           # [S, k2]
    rows = torch.arange(s_, device=dev)[:, None]
    h_glob = mesh.all_reduce(hist[rows, elected])               # [S, k2, B, 3]
    hist_e = torch.zeros_like(hist)
    hist_e[rows, elected] = h_glob
    emask = torch.zeros(s_, f_full, dtype=torch.float32, device=dev)
    emask[rows, elected] = 1.0
    fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    emask = torch.where(fm > 0, emask, torch.zeros_like(emask))
    return hist_e, emask
