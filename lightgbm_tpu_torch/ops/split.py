"""Best-split search over histograms, numerical features.

Port of the numerical path of the JAX package's ``ops/split.py``
(``find_best_split``): vectorized cumulative sums over the whole ``[F, B]``
histogram, both missing-value directions evaluated as two cumsum variants,
leaf output / gain closed forms with L1, L2, ``max_delta_step`` and path
smoothing, and the ``min_data_in_leaf`` / ``min_sum_hessian_in_leaf`` /
``min_gain_to_split`` gates; monotone-basic (candidates whose child outputs
violate the feature's direction are rejected, leaf outputs clamped to the
leaf's bounds), extra-trees (one random threshold per feature) and the
monotone split penalty (``gain_mult``).  The arithmetic runs in float32 in
the same order as the JAX code, so both packages pick the same split
wherever the best gain is not a near-tie.

Everything is batched over a leading dimension: ``hist [S, F, B, 3]`` and
totals ``[S]`` give an ``[S]``-batched ``SplitResult`` (the frontier's 2k
child searches in one call; the JAX package ``vmap``s the same function).

The categorical paths (one-hot and sorted many-category) are not ported.
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


def find_best_split(hist: torch.Tensor, num_bins: torch.Tensor,
                    nan_bins: torch.Tensor, sum_g, sum_h, count,
                    p: SplitParams, feature_mask: torch.Tensor,
                    output_lo=NEG_INF, output_hi=POS_INF,
                    monotone: torch.Tensor = None,
                    rand_threshold: torch.Tensor = None,
                    gain_mult: torch.Tensor = None) -> SplitResult:
    """Best numerical split of each leaf of a batch.

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
    Returns an ``[S]``-batched ``SplitResult``.
    """
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
    neg = torch.full_like(gain_fb, NEG_INF)
    if rand_threshold is not None:
        # extra_trees: each feature offers exactly ONE random threshold
        keep = bin_ids[None] == rand_threshold.to(dev)[:, :, None]
        gain_fb = torch.where(keep, gain_fb, neg)
    fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    gain_fb = torch.where(fm[:, :, None] > 0, gain_fb, neg)
    if gain_mult is not None:
        # monotone split penalty, rebased around parent gain + min_gain so
        # that the reported improvement is the reference's scaled gain
        pivot = (leaf_gain(total[:, 0], total[:, 1], p, 0.0, total[:, 2],
                           lo1, hi1) + p.min_gain_to_split)[:, None, None]
        gain_fb = torch.where(gain_fb > NEG_INF / 2,
                              pivot + (gain_fb - pivot) * gain_mult[:, :, None],
                              gain_fb)

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
    right = total - left
    lo_out = leaf_output(left[:, 0], left[:, 1], p, 0.0, left[:, 2],
                         lo1, hi1)
    hi_out = leaf_output(right[:, 0], right[:, 1], p, 0.0, right[:, 2],
                         lo1, hi1)

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
        cat_bits=torch.zeros(s_, cat_words(b), dtype=torch.int32, device=dev),
    )
