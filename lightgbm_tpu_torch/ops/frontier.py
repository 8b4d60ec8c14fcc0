"""Level-batched best-first tree growth — the main-path tree learner.

Port of the JAX package's ``ops/frontier.py`` (``grow_tree_frontier``) for
the serial learner, with ``feature_fraction_bynode``, ``extra_trees``,
monotone-basic, ``feature_contri``, categorical splits (one-hot and
sorted, each carrying the bitset of the bins that go left, decided by that
bitset in the partition)
and EFB (the histograms are kept per bundle column, ``Bb`` bins wide, and
expanded to per-feature ``[f, B]`` histograms before each split search; the
partition decodes a feature's bin from its bundle column).  The algorithm is the same: each round
expands the top-k pending leaves by ``g_hat(v) = min(gain(v),
g_hat(parent(v)))`` with one [N]-pass stable partition of the row
permutation, ONE leaf-grouped row gather feeding the batched histogram
kernel (``hist_leaves``, or ``hist_onehot_leaves`` under
``hist_method='onehot'``) for the k smaller children, the larger siblings
by subtraction, and one batched split search over the 2k children.  Growth
stops when no pending ``g_hat`` can displace an applied split, and a replay
of the leaf-slot argmaxes over the applied split records recovers the
exact best-first order and the reference's node/leaf numbering.

The per-node draws are keyed by split record as in the JAX version: the
root searches at step 0, both children of the expansion recorded at
``s_idx`` at step ``s_idx + 1`` (``grower.node_feature_mask_for``,
``rand_thresholds_for``).  Monotone-basic pinches each child's output
bounds at the midpoint of the split's outputs down the root path, and the
child's depth sets the split penalty.

What differs from the JAX version, and why:

- The round loop is a host ``while`` loop (JAX: ``lax.while_loop``).  Each
  round reads two scalars back from the device: the number of leaves it
  expands (zero is the stop test) and the number of histogram blocks.  No
  other device->host read happens inside the loop: the expanded leaves are
  a prefix of the ranked ones, so they are sliced, never boolean-masked.
- The histogram gather takes exactly ``nb_tot * BR`` rows instead of the
  smallest rung of a static capacity ladder (XLA needs static shapes;
  PyTorch does not).  The block layout is the JAX one: each of the k slots
  owns ``ceil(rows / BR)`` (at least one) consecutive ``BR``-row blocks.
- The replay and the tree assembly run on the host in numpy over the
  ``[S]``-sized split records (one small device->host copy per tree), where
  the JAX version runs a ``fori_loop`` of tiny device ops.  The host tree is
  returned alongside the device tree, so the booster needs no second copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..obs.tracer import DeviceRange, device_ranged
from .grower import (GrowerConfig, TreeArrays, _BestSplits, kernel_width,
                     monotone_gain_mult, node_feature_mask_for,
                     rand_thresholds_for)
from .histogram import (build_histogram, build_histogram_leaves,
                        movable_bins, widen_bins)
from .split import (NEG_INF, POS_INF, bitset_contains, cat_words,
                    find_best_split, leaf_output)

_SP_FLOAT = ("sp_ghat", "sp_gain", "sp_lout", "sp_rout", "sp_lweight",
             "sp_rweight", "sp_lcount", "sp_rcount", "sp_value", "sp_count")
_SP_INT = ("sp_parent", "sp_feature", "sp_threshold", "sp_begin", "sp_nrows",
           "sp_nleft")
_SP_BOOL = ("sp_is_left", "sp_dleft", "sp_iscat")


def _efb_tables(efb, B, Bb, dev):
    """``(expand_hist, decode_col, col_of_feat)`` for the EFB layout
    ``efb = (feat_bundle, feat_off, num_bins)`` (host numpy), or identities
    and None without EFB.  ``expand_hist`` maps ``[S, NC, Bb, 3]`` bundle
    histograms to ``[S, f, B, 3]`` feature histograms: bins ``1..nb-1`` of
    feature f are bundle bins ``off .. off + nb - 2``, and bin 0 is the
    bundle's total less those (the JAX package's ``expand_hist``)."""
    if efb is None:
        return (lambda hb: hb), (lambda colv, feat: colv), None
    fb_np, off_np, nb_np = efb
    f = int(fb_np.shape[0])
    spans = nb_np.astype(np.int64) - 1
    bidx = np.arange(B - 1, dtype=np.int64)[None, :]
    valid = bidx < spans[:, None]
    idx = (fb_np.astype(np.int64)[:, None] * Bb
           + off_np.astype(np.int64)[:, None] + bidx)
    idx = torch.as_tensor(np.where(valid, idx, 0).reshape(-1)).to(dev)
    valid_t = torch.as_tensor(valid.astype(np.float32)).to(dev)
    col_of_feat = torch.as_tensor(fb_np.astype(np.int64)).to(dev)
    off_of_feat = torch.as_tensor(off_np.astype(np.int64)).to(dev)
    nb_of_feat = torch.as_tensor(nb_np.astype(np.int64)).to(dev)

    def expand_hist(hb):
        s_ = hb.shape[0]
        g = hb.reshape(s_, -1, 3)[:, idx].reshape(s_, f, B - 1, 3)
        g = g * valid_t[None, :, :, None]
        totals = hb.sum(2)                                 # [S, NC, 3]
        bin0 = totals[:, col_of_feat] - g.sum(2)
        return torch.cat([bin0[:, :, None, :], g], dim=2)

    def decode_col(colv, feat):
        off = off_of_feat[feat]
        nbf = nb_of_feat[feat]
        return torch.where((colv >= off) & (colv < off + nbf - 1),
                           colv - off + 1, torch.zeros_like(colv))
    return expand_hist, decode_col, col_of_feat


def grow_tree_frontier(bins, grad, hess, row_weight, feature_mask, num_bins,
                       nan_bins, cfg: GrowerConfig, key=None, monotone=None,
                       is_categorical=None, efb=None, feature_contri=None):
    """Grow one tree with round-batched best-first expansion.

    ``bins [N, NC]`` u8 or u16 and the ``[N]`` f32 row vectors live on one
    device.  ``key`` seeds the per-node draws (needed for
    ``feature_fraction_bynode < 1`` and ``extra_trees``), ``monotone [F]``
    the directions (needed when ``cfg.has_monotone``), ``is_categorical
    [F]`` marks categorical features (None: none), and ``efb`` is the
    bundle layout ``(feat_bundle, feat_off, num_bins)`` of numpy arrays
    when ``bins`` holds EFB bundle columns (``cfg.bundle_bins`` wide);
    ``feature_contri [F]`` scales each feature's gains (None: all 1).
    Returns ``(TreeArrays on that device, node_assignment [N] int64,
    TreeArrays of numpy arrays)``."""
    dev = bins.device
    n, n_cols = bins.shape
    f = int(efb[0].shape[0]) if efb is not None else n_cols
    L = cfg.num_leaves
    B = cfg.max_bin
    Bb = kernel_width(cfg)
    cw = cat_words(B)
    p = cfg.split
    k = max(1, min(cfg.frontier_k, L - 1))
    BR = cfg.frontier_block_rows
    S = (L - 1) + 2 * k              # split-record capacity (overshoot slack)
    LS = L + 2 * k                   # leaf-slot capacity

    def i64(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int64, device=dev)

    def f32(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    tot = torch.stack([torch.sum(grad * row_weight),
                       torch.sum(hess * row_weight), torch.sum(row_weight)])
    if f == 0:
        return _single_leaf(tot, n, L, cw, dev)
    expand_hist, decode_col, col_of_feat = _efb_tables(efb, B, Bb, dev)
    sorted_cat = (torch.as_tensor(cfg.sorted_cat, dtype=torch.int64).to(dev)
                  if cfg.sorted_cat else None)

    # combined row payload: (grad, hess, row_weight) as 12 trailing bytes
    # in bin-typed columns (12 u8 or 6 u16), so one row gather moves bins
    # and gradients together; u16 moves as int16 (movable_bins)
    bins_mv = movable_bins(bins)
    gh_packed = torch.stack([grad, hess, row_weight], 1).contiguous().view(
        bins_mv.dtype)                                      # [N, 12 // esz]
    comb = torch.cat([bins_mv, gh_packed], dim=1)           # [N, NC + gh]

    use_mono = cfg.has_monotone
    use_pen = use_mono and cfg.monotone_penalty > 0.0
    # the per-node draws of every step a round can name (0..S+k: a round's
    # unused slots name steps past S), drawn once a tree on the key's
    # device (the booster's key is on the host: a few hundred small CPU
    # ops and one copy a tree, where a draw per round cost as many again
    # every round) and gathered by step
    all_steps = torch.arange(S + k + 1)
    node_masks = (node_feature_mask_for(key, all_steps, feature_mask,
                                        cfg.feature_fraction_bynode)
                  if cfg.feature_fraction_bynode < 1.0 else None)
    node_thr = (rand_thresholds_for(key, all_steps, cfg.extra_seed,
                                    num_bins, nan_bins)
                if cfg.extra_trees else None)

    def find(hist_b, sum_g, sum_h, count, steps, lo=NEG_INF, hi=POS_INF,
             depth=None):
        """The batched search; ``steps [S]`` keys the per-node draws, ``lo``
        and ``hi`` are the leaves' monotone bounds, ``depth [S]`` their
        depth for the monotone penalty."""
        fmask = node_masks[steps] if node_masks is not None else feature_mask
        rand = node_thr[steps] if node_thr is not None else None
        mult = (monotone_gain_mult(depth, monotone, cfg.monotone_penalty)
                if use_pen else None)
        return find_best_split(expand_hist(hist_b), num_bins, nan_bins,
                               sum_g, sum_h, count, p, fmask, output_lo=lo,
                               output_hi=hi,
                               monotone=monotone if use_mono else None,
                               rand_threshold=rand, gain_mult=mult,
                               is_categorical=is_categorical,
                               sorted_cat=sorted_cat, contri=feature_contri)

    # obs_trace_device: the phases as profiler ranges (the JAX package's
    # lgbm/* named scopes); off, nothing more is called
    trace = cfg.trace_device
    nvtx = trace and dev.type == "cuda"
    build_full, build_leaves = build_histogram, build_histogram_leaves
    if trace:
        build_full = device_ranged("lgbm/hist", build_full, nvtx)
        build_leaves = device_ranged("lgbm/hist", build_leaves, nvtx)
        find = device_ranged("lgbm/split_search", find, nvtx)

    # ---- root -------------------------------------------------------------
    root_hist = build_full(bins, grad, hess, row_weight, Bb,
                           method=cfg.hist_method, variant=cfg.hist_variant)
    root_step = torch.zeros(1, dtype=torch.int64, device=dev)
    root_split = find(root_hist[None], tot[0:1], tot[1:2], tot[2:3],
                      root_step, depth=root_step)

    pend = _BestSplits.empty(LS, cw, dev).set_rows(
        torch.zeros(1, dtype=torch.int64, device=dev), root_split)
    pend_ghat = f32(LS, fill=NEG_INF)
    pend_ghat[0] = torch.clamp(root_split.gain[0], max=POS_INF)
    leaf_begin = i64(LS)
    leaf_nrows = i64(LS)
    leaf_nrows[0] = n
    leaf_depth = i64(LS)
    leaf_sum_g, leaf_weight, leaf_count = f32(LS), f32(LS), f32(LS)
    leaf_sum_g[0], leaf_weight[0], leaf_count[0] = tot[0], tot[1], tot[2]
    leaf_cghat = f32(LS, fill=POS_INF)      # creator split g_hat
    leaf_cs = i64(LS, fill=-1)              # creator split idx
    leaf_il = torch.zeros(LS, dtype=torch.bool, device=dev)  # was left child
    if use_mono:
        # per-leaf monotone output bounds (basic mode: root-path state only)
        leaf_lo, leaf_hi = f32(LS, fill=NEG_INF), f32(LS, fill=POS_INF)
    hist = f32(LS, n_cols, Bb, 3)
    hist[0] = root_hist
    sp = {name: f32(S) for name in _SP_FLOAT}
    sp["sp_catbits"] = torch.zeros(S, cw, dtype=torch.int32, device=dev)
    sp["sp_ghat"].fill_(NEG_INF)
    sp.update({name: i64(S) for name in _SP_INT})
    sp["sp_parent"].fill_(-1)
    sp.update({name: torch.zeros(S, dtype=torch.bool, device=dev)
               for name in _SP_BOOL})
    perm = torch.arange(n, dtype=torch.int64, device=dev)
    pos_leaf = i64(n)
    pos_idx = torch.arange(n, dtype=torch.int64, device=dev)
    i_ar = torch.arange(k, dtype=torch.int64, device=dev)
    applied = 0

    while applied < S:
        if trace:
            rnd = DeviceRange("lgbm/frontier_round", nvtx).open()
        # expansion priority: g_hat primary, RAW gain secondary, index last
        # (the JAX lexsort, as two stable sorts)
        o1 = torch.argsort(-pend.gain, stable=True)
        sel = o1[torch.argsort(-pend_ghat[o1], stable=True)][:k]
        ghat_sel = pend_ghat[sel]
        t_full = torch.topk(sp["sp_ghat"], L - 1).values[-1]
        valid = ((ghat_sel > 0.0) & (applied + i_ar < S)
                 & ((applied + i_ar < L - 1) | (ghat_sel >= t_full)))
        # ghat_sel falls and every term is monotone in the rank, so the
        # valid slots are a prefix of length v; v == 0 is the JAX loop's
        # stop test.  Slicing by v keeps boolean-mask indexing (one
        # device->host sync per mask) out of the round.
        v = int(valid.sum())
        if v == 0:
            if trace:
                rnd.close()
            break

        sel_feat = pend.feature[sel].long()
        sel_thr = pend.threshold[sel].long()
        sel_dleft = pend.default_left[sel]
        sel_cbits = pend.cat_bits[sel]                      # [k, CW]
        sel_iscat = (is_categorical[sel_feat] if is_categorical is not None
                     else torch.zeros_like(sel_dleft))
        sel_gain = pend.gain[sel]
        sp_ghat_i = torch.minimum(sel_gain, leaf_cghat[sel])
        right_slot = applied + 1 + i_ar           # leaf slot of right child
        s_idx = applied + i_ar                    # split record index
        left_smaller = pend.lc[sel] <= pend.rc[sel]

        # ---- [N]-pass: decide + segmented stable partition ----------------
        slot_of_leaf = i64(LS, fill=-1)
        slot_of_leaf[sel[:v]] = i_ar[:v]
        lf = pos_leaf
        si = slot_of_leaf[lf]
        act = si >= 0
        sic = si.clamp(min=0)
        feat_p = sel_feat[sic]
        col_p = col_of_feat[feat_p] if col_of_feat is not None else feat_p
        colv = decode_col(widen_bins(bins_mv[perm, col_p]), feat_p)
        nb_p = nan_bins.long()[feat_p]
        is_miss = (colv == nb_p) & (nb_p >= 0)
        gl = torch.where(is_miss, sel_dleft[sic], colv <= sel_thr[sic])
        if is_categorical is not None:
            # categorical: the split's bin bitset decides
            gl = torch.where(sel_iscat[sic],
                             bitset_contains(sel_cbits, colv, sic), gl)
        gl_a = gl & act
        zero1 = torch.zeros(1, dtype=torch.int64, device=dev)
        cum_l = torch.cat([zero1, torch.cumsum(gl_a, 0)])
        cum_a = torch.cat([zero1, torch.cumsum(act, 0)])
        beg_p = leaf_begin[lf]
        rank_l = cum_l[1:] - gl_a.long() - cum_l[beg_p]     # exclusive
        rank_a = cum_a[1:] - act.long() - cum_a[beg_p]
        rank_r = rank_a - rank_l
        sel_beg = leaf_begin[sel]
        sel_rows = leaf_nrows[sel]
        nl_i = cum_l[sel_beg + sel_rows] - cum_l[sel_beg]  # [k] raw left
        new_pos = torch.where(act, beg_p + torch.where(gl, rank_l,
                                                       nl_i[sic] + rank_r),
                              pos_idx)
        perm_new = torch.empty_like(perm)
        perm_new[new_pos] = perm
        pos_leaf_new = torch.empty_like(pos_leaf)
        pos_leaf_new[new_pos] = torch.where(gl | ~act, lf, right_slot[sic])
        nr_i = sel_rows - nl_i

        # ---- batched smaller-child histograms -----------------------------
        small_n = torch.where(valid, torch.where(left_smaller, nl_i, nr_i), 0)
        small_beg = torch.where(left_smaller, sel_beg, sel_beg + nl_i)
        nblocks = torch.clamp((small_n + BR - 1) // BR, min=1)   # every slot
        nb_tot = int(nblocks.sum())
        blk_start = torch.cumsum(nblocks, 0) - nblocks
        i_of_blk = torch.repeat_interleave(i_ar, nblocks, output_size=nb_tot)
        q = torch.arange(nb_tot * BR, dtype=torch.int64, device=dev)
        qb = q // BR
        i_of_q = i_of_blk[qb]
        local = (qb - blk_start[i_of_q]) * BR + q % BR
        okrow = local < small_n[i_of_q]
        rid = perm_new[torch.clamp(small_beg[i_of_q] + local, 0, n - 1)]
        combb = comb[torch.where(okrow, rid, 0)]
        ghb = combb[:, n_cols:].contiguous().view(torch.float32)  # [C, 3]
        m = torch.where(okrow, ghb[:, 2], 0.0)
        hist_small = build_leaves(
            combb.view(bins.dtype), ghb[:, 0].contiguous(),
            ghb[:, 1].contiguous(), m, i_of_blk.to(torch.int32), k, Bb,
            block_rows=BR, f_limit=n_cols, method=cfg.hist_method,
            variant=cfg.hist_variant)

        parent_hist = hist[sel]
        large_hist = parent_hist - hist_small
        ls4 = left_smaller[:, None, None, None]
        lhist = torch.where(ls4, hist_small, large_hist)
        rhist = parent_hist - lhist

        # ---- 2k child split searches (one batched call) -------------------
        lg, rg = pend.lg[sel], pend.rg[sel]
        lh, rh = pend.lh[sel], pend.rh[sel]
        lc, rc = pend.lc[sel], pend.rc[sel]
        depth_c = leaf_depth[sel] + 1
        # both children of the expansion recorded at s_idx draw at step
        # s_idx + 1 (siblings share a draw, as in the sequential grower)
        steps2 = torch.cat([s_idx, s_idx]) + 1
        if use_mono:
            # basic mode: pinch both children at the midpoint of the
            # split's outputs (reference BasicConstraint) -- it depends
            # only on the expansion's own path, so batching cannot reorder
            # it
            mono_sel = monotone[sel_feat]
            lo_p, hi_p = leaf_lo[sel], leaf_hi[sel]
            mid = (pend.lout[sel] + pend.rout[sel]) * 0.5
            l_lo = torch.where(mono_sel < 0, torch.maximum(lo_p, mid), lo_p)
            l_hi = torch.where(mono_sel > 0, torch.minimum(hi_p, mid), hi_p)
            r_lo = torch.where(mono_sel > 0, torch.maximum(lo_p, mid), lo_p)
            r_hi = torch.where(mono_sel < 0, torch.minimum(hi_p, mid), hi_p)
            lo2, hi2 = torch.cat([l_lo, r_lo]), torch.cat([l_hi, r_hi])
        else:
            lo2, hi2 = NEG_INF, POS_INF
        s2 = find(torch.cat([lhist, rhist]), torch.cat([lg, rg]),
                  torch.cat([lh, rh]), torch.cat([lc, rc]), steps2, lo2, hi2,
                  torch.cat([depth_c, depth_c]))
        depth_ok = (cfg.max_depth <= 0) | (depth_c < cfg.max_depth)
        gain2 = torch.where(torch.cat([depth_ok, depth_ok]), s2.gain,
                            torch.full_like(s2.gain, NEG_INF))
        s2 = s2._replace(gain=gain2)

        # ---- split records (read the OLD leaf state first) ----------------
        sp_value_i = leaf_output(leaf_sum_g[sel], leaf_weight[sel], p, 0.0,
                                 leaf_count[sel])
        recs = dict(
            sp_ghat=sp_ghat_i, sp_parent=leaf_cs[sel], sp_is_left=leaf_il[sel],
            sp_feature=sel_feat, sp_threshold=sel_thr, sp_dleft=sel_dleft,
            sp_iscat=sel_iscat, sp_catbits=sel_cbits,
            sp_gain=sel_gain, sp_lout=pend.lout[sel], sp_rout=pend.rout[sel],
            sp_lweight=lh, sp_rweight=rh, sp_lcount=lc, sp_rcount=rc,
            sp_value=sp_value_i, sp_count=leaf_count[sel], sp_begin=sel_beg,
            sp_nrows=sel_rows, sp_nleft=nl_i)
        for name, val in recs.items():
            sp[name][applied:applied + v] = val[:v]

        # ---- leaf bookkeeping: left child keeps the slot, right is new ----
        vs, vr = sel[:v], right_slot[:v]

        def upd(arr, left_val, right_val):
            arr[vs] = left_val[:v].to(arr.dtype)
            arr[vr] = right_val[:v].to(arr.dtype)

        leaf_begin[vr] = (sel_beg + nl_i)[:v]
        upd(leaf_nrows, nl_i, nr_i)
        upd(leaf_depth, depth_c, depth_c)
        upd(leaf_sum_g, lg, rg)
        upd(leaf_weight, lh, rh)
        upd(leaf_count, lc, rc)
        upd(leaf_cghat, sp_ghat_i, sp_ghat_i)
        upd(leaf_cs, s_idx, s_idx)
        upd(leaf_il, torch.ones_like(valid), torch.zeros_like(valid))
        if use_mono:
            upd(leaf_lo, l_lo, r_lo)
            upd(leaf_hi, l_hi, r_hi)
        hist[vs] = lhist[:v]
        hist[vr] = rhist[:v]
        sl = type(s2)(*[a[:k] for a in s2])
        sr = type(s2)(*[a[k:] for a in s2])
        pend.set_rows(vs, type(sl)(*[a[:v] for a in sl]))
        pend.set_rows(vr, type(sr)(*[a[:v] for a in sr]))
        upd(pend_ghat, torch.minimum(sl.gain, sp_ghat_i),
            torch.minimum(sr.gain, sp_ghat_i))
        perm, pos_leaf = perm_new, pos_leaf_new
        applied += v
        if trace:
            rnd.close()

    host = {name: t.cpu().numpy() for name, t in sp.items()}
    tot_h = tot.cpu().numpy()
    tree_np, leaf_beg, leaf_nr = _replay(host, applied, L, S, cw, n, tot_h)
    tree = TreeArrays(*[torch.as_tensor(a).to(dev) for a in tree_np])

    # ---- node assignment from final leaf row ranges ----------------------
    begins = np.where(leaf_nr > 0, leaf_beg, n + 1 + np.arange(L))
    lorder = np.argsort(begins, kind="stable")
    sorted_begin = torch.as_tensor(begins[lorder]).to(dev)
    rank = torch.searchsorted(sorted_begin, pos_idx, right=True)
    leaf_of_pos = torch.as_tensor(lorder).to(dev)[torch.clamp(rank - 1, min=0)]
    node_assign = torch.empty(n, dtype=torch.int64, device=dev)
    node_assign[perm] = leaf_of_pos
    return tree, node_assign, tree_np


def _replay(sp, applied, L, S, cw, n, tot):
    """Exact best-first order over the applied split records: the leaf-slot
    argmax loop of the sequential grower (lowest leaf id wins a tie), then
    the flat tree in the reference numbering (left child keeps the parent's
    leaf id, right child of the j-th split is leaf j+1).  numpy, host."""
    neg = np.float32(NEG_INF)
    appl = np.arange(S) < applied
    parent, is_left = sp["sp_parent"], sp["sp_is_left"]
    has_par = appl & (parent >= 0)
    child_left = np.full(S, -1, np.int64)
    child_right = np.full(S, -1, np.int64)
    recs = np.arange(S)
    child_left[parent[has_par & is_left]] = recs[has_par & is_left]
    child_right[parent[has_par & ~is_left]] = recs[has_par & ~is_left]
    gain = sp["sp_gain"]

    def gain_of(r):
        return gain[r] if r >= 0 else neg

    cur_rec = np.full(L, -1, np.int64)
    cur_rec[0] = 0 if applied > 0 else -1   # record 0 is the root split
    gains = np.full(L, neg, np.float32)
    gains[0] = gain_of(cur_rec[0])
    order = np.full(L - 1, -1, np.int64)
    leaf_of_node = np.full(L - 1, -1, np.int64)
    nsel = 0
    for j in range(L - 1):
        pop = int(np.argmax(gains))
        if not gains[pop] > 0.0:
            break
        rec = cur_rec[pop]
        order[j] = rec
        leaf_of_node[j] = pop
        lc, rc = child_left[rec], child_right[rec]
        new_id = min(j + 1, L - 1)
        cur_rec[pop] = lc
        cur_rec[new_id] = rc
        gains[pop] = gain_of(lc)
        gains[new_id] = gain_of(rc)
        nsel += 1

    node_on = order >= 0
    src = np.clip(order, 0, None)
    leaf_id_of_node = np.maximum(leaf_of_node, 0)
    node_ids = np.arange(L - 1)
    pos_of_rec = np.full(S, -1, np.int64)
    pos_of_rec[src[node_on]] = node_ids[node_on]

    def child_ptr(crec, default_leaf):
        c = crec[src]
        cpos = pos_of_rec[np.clip(c, 0, None)]
        return np.where(node_on,
                        np.where((c >= 0) & (cpos >= 0), cpos, ~default_leaf),
                        -1).astype(np.int32)

    left_child = child_ptr(child_left, leaf_id_of_node)
    right_child = child_ptr(child_right, node_ids + 1)
    lleaf = node_on & (left_child < 0)
    rleaf = node_on & (right_child < 0)
    lids = np.clip(leaf_id_of_node, 0, L - 1)
    rids = np.clip(node_ids + 1, 0, L - 1)

    def leafset(vl, vr, dtype):
        a = np.zeros(L, dtype)
        a[lids[lleaf]] = vl[lleaf]
        a[rids[rleaf]] = vr[rleaf]
        return a

    def rec_of(name):
        return sp[name][src]

    no_split = nsel == 0
    leaf_value = leafset(rec_of("sp_lout"), rec_of("sp_rout"), np.float32)
    leaf_count = leafset(rec_of("sp_lcount"), rec_of("sp_rcount"), np.float32)
    leaf_weight = leafset(rec_of("sp_lweight"), rec_of("sp_rweight"),
                          np.float32)
    if no_split:
        leaf_count[0] = tot[2]
        leaf_weight[0] = tot[1]
    zf = np.float32(0.0)
    tree = TreeArrays(
        split_feature=np.where(node_on, rec_of("sp_feature"), -1).astype(np.int32),
        threshold=np.where(node_on, rec_of("sp_threshold"), 0).astype(np.int32),
        default_left=node_on & rec_of("sp_dleft"),
        is_cat_split=node_on & rec_of("sp_iscat"),
        cat_bits=np.where(node_on[:, None], rec_of("sp_catbits"),
                          0).astype(np.int32),
        split_gain=np.where(node_on, rec_of("sp_gain"), zf).astype(np.float32),
        left_child=left_child,
        right_child=right_child,
        leaf_value=leaf_value,
        leaf_count=leaf_count,
        leaf_weight=leaf_weight,
        internal_value=np.where(node_on, rec_of("sp_value"), zf).astype(np.float32),
        internal_count=np.where(node_on, rec_of("sp_count"), zf).astype(np.float32),
        num_leaves=np.array(nsel + 1, np.int32))

    lbeg = rec_of("sp_begin")
    lnl = rec_of("sp_nleft")
    leaf_beg = leafset(lbeg, lbeg + lnl, np.int64)
    leaf_nr = leafset(lnl, rec_of("sp_nrows") - lnl, np.int64)
    if no_split:
        leaf_nr[0] = n
    return tree, leaf_beg, leaf_nr


def _single_leaf(tot, n, L, cw, dev):
    """No usable features: a single-leaf tree over every row."""
    t = tot.cpu().numpy()
    leaf_count = np.zeros(L, np.float32)
    leaf_weight = np.zeros(L, np.float32)
    leaf_count[0], leaf_weight[0] = t[2], t[1]
    tree_np = TreeArrays(
        split_feature=np.full(L - 1, -1, np.int32),
        threshold=np.zeros(L - 1, np.int32),
        default_left=np.zeros(L - 1, bool),
        is_cat_split=np.zeros(L - 1, bool),
        cat_bits=np.zeros((L - 1, cw), np.int32),
        split_gain=np.zeros(L - 1, np.float32),
        left_child=np.full(L - 1, -1, np.int32),
        right_child=np.full(L - 1, -1, np.int32),
        leaf_value=np.zeros(L, np.float32),
        leaf_count=leaf_count, leaf_weight=leaf_weight,
        internal_value=np.zeros(L - 1, np.float32),
        internal_count=np.zeros(L - 1, np.float32),
        num_leaves=np.array(1, np.int32))
    tree = TreeArrays(*[torch.as_tensor(a).to(dev) for a in tree_np])
    return tree, torch.zeros(n, dtype=torch.int64, device=dev), tree_np
