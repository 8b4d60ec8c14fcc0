"""Learning-to-rank objectives: LambdarankNDCG and RankXENDCG.

Port of the JAX package's ``objective/rank.py`` (reference
``src/objective/rank_objective.hpp``; LambdarankNDCG at :98, RankXENDCG at
:284): queries are packed into a padded ``[Q, L]`` layout, ``L`` the longest
query rounded up to a multiple of 8 (``_pad_queries``), and the pairwise
lambdas are masked ``[C, W, W]`` broadcast algebra over chunks of queries.

Semantics kept from the reference (through the JAX package): label gains
``2^label - 1``, position discount ``1/log2(2 + rank)``, per-pair |ΔNDCG|
with the inverse max DCG of the query, the score-distance regulariser and
the total-lambda normalisation under ``lambdarank_norm``, pairs of differing
labels with the higher-sorted document above ``lambdarank_truncation_level``,
and the exact sigmoid.

What differs from the JAX version, and why: each query is independent, so
lambdarank pads each query only to its length bucket (``_BUCKETS``, at most
``L``) rather than to ``L`` for all of them, and takes chunks of up to
``_CHUNK_ELEMS`` pair entries, many more on the card (a ``[C, W, W]`` block
per chunk; at MSLR width, queries of ~120 documents and one of 1,251, the
common layout would spend most of its work on padding).  A padded slot adds
exact zeros, so the values are the same but for the float32 rounding of
the sums.  rank_xendcg keeps the common ``[Q, L]`` layout: its draw
``uniform(key, Q * L)`` is laid out by ``L``, so the padding decides which
draw a document gets.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log, check
from ..utils.random_gen import prng_key, uniform
from .base import ObjectiveFunction

#: cap on ranked positions contributing discount (dcg_calculator.cpp:17)
K_MAX_POSITION = 10000
# the padded widths of lambdarank's per-query buckets (multiples of 8)
_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
            1536, 2048, 3072, 4096, 6144, 8192)
# pair entries of one lambdarank chunk ([C, W, W] float32): the JAX
# package's ~64 MB block on the CPU, 16 times that on the card
_CHUNK_ELEMS = {"cpu": 16 << 20, "cuda": 256 << 20}


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """``2^i - 1`` gains (reference ``DCGCalculator::DefaultLabelGain``)."""
    g = np.zeros(max_label, np.float64)
    for i in range(1, max_label):
        g[i] = float((1 << i) - 1)
    return g


def check_rank_labels(label: np.ndarray, num_gains: int) -> None:
    """Reference ``DCGCalculator::CheckLabel``."""
    if np.any(np.abs(label - np.round(label)) > 1e-10):
        Log.fatal("label should be int type for ranking task")
    if np.any(label < 0):
        Log.fatal("Label should be non-negative for ranking task")
    if np.any(label >= num_gains):
        Log.fatal("Label is not less than the number of label mappings (%d)",
                  num_gains)


def max_dcg_at_k(k: int, labels: np.ndarray, gains: np.ndarray) -> float:
    """Reference ``DCGCalculator::CalMaxDCGAtK``: ideal DCG using the best-k
    labels in descending order."""
    k = min(k, len(labels))
    if k <= 0:
        return 0.0
    top = np.sort(labels.astype(np.int64))[::-1][:k]
    disc = 1.0 / np.log2(2.0 + np.arange(k))
    return float(np.sum(gains[top] * disc))


def _pad_queries(boundaries: np.ndarray, lane: int = 8):
    """The padded ``[Q, L]`` gather layout of a query-boundary array: ``L``
    the longest query rounded up to a multiple of ``lane`` (8, as the JAX
    package lays out its TPU lanes: rank_xendcg's draw depends on it);
    padded slots point at the query's first row and are masked out."""
    counts = np.diff(boundaries).astype(np.int64)
    Q = len(counts)
    L = int(max(1, counts.max()))
    L = -(-L // lane) * lane
    idx = boundaries[:-1, None] + np.minimum(np.arange(L)[None, :],
                                             np.maximum(counts[:, None] - 1, 0))
    mask = np.arange(L)[None, :] < counts[:, None]
    return idx.astype(np.int64), mask, Q, L, counts


class RankingObjective(ObjectiveFunction):
    """Shared query machinery (reference ``RankingObjective``,
    ``rank_objective.hpp:25``)."""

    def __init__(self, config):
        super().__init__(config)
        self.seed = config.objective_seed

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        check(self.query_boundaries is not None,
              "Ranking tasks require query information")
        self._bounds = np.asarray(self.query_boundaries, np.int64)
        self._qidx, self._qmask, self.num_queries, self.L, self._counts = \
            _pad_queries(self._bounds)
        self._dev_cache = {}

    def _on(self, dev, name, make):
        """``make()``'s tensors, made once per device."""
        key = (dev, name)
        if key not in self._dev_cache:
            self._dev_cache[key] = make()
        return self._dev_cache[key]

    @property
    def is_ranking(self) -> bool:
        return True


class LambdarankNDCG(RankingObjective):
    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        gains = (np.asarray(config.label_gain, np.float64)
                 if config.label_gain else default_label_gain())
        self.label_gain = gains
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero", self.sigmoid)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        check_rank_labels(self.label, len(self.label_gain))
        # inverse max DCG per query at the truncation level
        # (rank_objective.hpp:124-136)
        inv = np.zeros(self.num_queries, np.float64)
        b = self._bounds
        for i in range(self.num_queries):
            m = max_dcg_at_k(self.truncation_level, self.label[b[i]:b[i + 1]],
                             self.label_gain)
            inv[i] = 1.0 / m if m > 0 else 0.0
        self._inv_max_dcg = inv.astype(np.float32)
        L = self.L
        disc = np.zeros(L, np.float64)
        upto = min(L, K_MAX_POSITION)
        disc[:upto] = 1.0 / np.log2(2.0 + np.arange(upto))
        self._discount = disc.astype(np.float32)
        # queries by length bucket: (width, query ids); a bucket never
        # exceeds the common width L
        widths = np.array([w for w in _BUCKETS if w < L] + [L])
        qb = np.searchsorted(widths, self._counts)
        self._buckets = []
        for j, w in enumerate(widths):
            qs = np.flatnonzero(qb == j)
            if qs.size:
                idx, mask = _bucket_layout(self._bounds, qs, int(w))
                self._buckets.append((int(w), qs, idx, mask))

    def get_gradients(self, score, label, weight):
        dev = score.device
        score = score.to(torch.float32)
        label = label.to(torch.float32)
        gain_t = self._on(dev, "gain", lambda: torch.as_tensor(
            self.label_gain.astype(np.float32)).to(dev))
        disc_t = self._on(dev, "disc", lambda: torch.as_tensor(
            self._discount).to(dev))
        inv_t = self._on(dev, "inv", lambda: torch.as_tensor(
            self._inv_max_dcg).to(dev))
        budget = _CHUNK_ELEMS["cuda" if dev.type == "cuda" else "cpu"]
        g = torch.zeros(self.num_data, dtype=torch.float32, device=dev)
        h = torch.zeros_like(g)
        for bi, (w, qs, idx, mask) in enumerate(self._buckets):
            idx_t, mask_t, qs_t = self._on(dev, ("bucket", bi), lambda: (
                torch.as_tensor(idx).to(dev), torch.as_tensor(mask).to(dev),
                torch.as_tensor(qs).to(dev)))
            chunk = max(1, budget // (w * w))
            for c0 in range(0, len(qs), chunk):
                sl = slice(c0, c0 + chunk)
                ci, cm = idx_t[sl], mask_t[sl]
                lam, hes = _lambdarank_padded(
                    score[ci], label[ci], cm, gain_t, disc_t[:w],
                    inv_t[qs_t[sl]], sigmoid=float(self.sigmoid),
                    norm=bool(self.norm), trunc=int(self.truncation_level))
                g[ci[cm]] = lam[cm]
                h[ci[cm]] = hes[cm]
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h


def _bucket_layout(bounds: np.ndarray, qs: np.ndarray, w: int):
    """``[len(qs), w]`` gather indices and mask of queries ``qs``."""
    starts = bounds[qs]
    counts = bounds[qs + 1] - starts
    idx = starts[:, None] + np.minimum(np.arange(w)[None, :],
                                       np.maximum(counts[:, None] - 1, 0))
    mask = np.arange(w)[None, :] < counts[:, None]
    return idx.astype(np.int64), mask


def _lambdarank_padded(ps, pl, mask, gain_table, discount, inv_max_dcg, *,
                       sigmoid: float, norm: bool, trunc: int):
    """Lambdarank gradients of ``C`` padded queries (the JAX package's
    ``_lambdarank_padded`` for one chunk).

    ps/pl/mask: ``[C, W]``; returns ``([C, W], [C, W])`` lambdas and
    hessians in the original (unsorted) within-query positions."""
    W = ps.shape[1]
    dev = ps.device
    inf = torch.tensor(float("inf"), device=dev)
    # stable descending sort by score within each query; padded slots sink
    sort_key = torch.where(mask, -ps, inf)
    order = torch.sort(sort_key, dim=1, stable=True).indices
    ss = torch.gather(ps, 1, order)
    sl = torch.gather(pl, 1, order)
    sm = torch.gather(mask, 1, order)
    sgain = gain_table[sl.long()]
    best = torch.where(sm, ss, -inf).amax(1)
    worst = torch.where(sm, ss, inf).amin(1)
    pos = torch.arange(W, device=dev)
    trunc_ok = torch.minimum(pos[:, None], pos[None, :]) < trunc   # [W, W]
    smf = sm.to(torch.float32)
    # pair tensors [C, W, W]; axis 1 = "a", axis 2 = "b"
    delta_s = ss[:, :, None] - ss[:, None, :]
    high = sl[:, :, None] > sl[:, None, :]
    valid = (smf[:, :, None] * smf[:, None, :]) * trunc_ok[None]
    dcg_gap = torch.abs(sgain[:, :, None] - sgain[:, None, :])
    pair_disc = torch.abs(discount[None, :, None] - discount[None, None, :])
    delta_ndcg = dcg_gap * pair_disc * inv_max_dcg[:, None, None]
    if norm:
        has_range = (best != worst)[:, None, None]
        delta_ndcg = torch.where(has_range,
                                 delta_ndcg / (0.01 + torch.abs(delta_s)),
                                 delta_ndcg)
    p = torch.sigmoid(-sigmoid * delta_s)
    lam = sigmoid * delta_ndcg * p
    hes = sigmoid * sigmoid * delta_ndcg * p * (1.0 - p)
    zero = torch.zeros((), device=dev)
    w_high = torch.where(high, valid, zero)
    w_low = torch.where(high.transpose(1, 2), valid, zero)
    # the high document is pushed up: a negative gradient
    # (rank_objective.hpp:208-213)
    lam_a = (-torch.sum(w_high * lam, 2)
             + torch.sum(w_low * lam.transpose(1, 2), 2))
    hes_a = torch.sum((w_high + w_low) * hes, 2)
    if norm:
        sum_lambdas = torch.sum(w_high * lam, (1, 2)) * 2.0
        nf = torch.where(sum_lambdas > 0,
                         torch.log2(1.0 + sum_lambdas)
                         / torch.clamp(sum_lambdas, min=1e-20),
                         torch.ones_like(sum_lambdas))[:, None]
        lam_a, hes_a = lam_a * nf, hes_a * nf
    # back to the original within-query positions
    lam = torch.empty_like(lam_a).scatter_(1, order, lam_a)
    hes = torch.empty_like(hes_a).scatter_(1, order, hes_a)
    return lam, hes


class RankXENDCG(RankingObjective):
    """Cross-entropy surrogate for NDCG, arxiv.org/abs/1911.09798
    (reference ``rank_objective.hpp:284``).  Iteration ``i`` draws
    ``uniform(key(objective_seed + 7919 i), Q * L)`` laid out ``[Q, L]``,
    the JAX package's ``uniform(PRNGKey(...), (Q, L))`` bit for bit."""

    name = "rank_xendcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self._iter = 0

    def draw(self, iteration: int, device) -> torch.Tensor:
        """The ``[Q, L]`` uniforms of an iteration, on ``device``."""
        key = prng_key(self.seed + iteration * 7919, device)
        return uniform(key, self.num_queries * self.L).view(
            self.num_queries, self.L)

    def get_gradients(self, score, label, weight):
        dev = score.device
        u = self.draw(self._iter, dev)
        self._iter += 1
        idx_t, mask_t = self._on(dev, "layout", lambda: (
            torch.as_tensor(self._qidx).to(dev),
            torch.as_tensor(self._qmask).to(dev)))
        lam, hes = _xendcg_padded(score.to(torch.float32)[idx_t],
                                  label.to(torch.float32)[idx_t], mask_t, u)
        g = torch.zeros(self.num_data, dtype=torch.float32, device=dev)
        h = torch.zeros_like(g)
        g[idx_t[mask_t]] = lam[mask_t]
        h[idx_t[mask_t]] = hes[mask_t]
        if weight is not None:
            g, h = g * weight, h * weight
        return g, h


def _xendcg_padded(ps, pl, mask, u):
    """Padded XE-NDCG gradients (reference per-query loop at
    ``rank_objective.hpp:303-357``), vectorised over queries."""
    zero = torch.zeros((), device=ps.device)
    logits = torch.where(mask, ps, torch.full_like(ps, -1e30))
    # softmax as jax.nn.softmax forms it
    ex = torch.exp(logits - logits.amax(1, keepdim=True))
    rho = torch.where(mask, ex / ex.sum(1, keepdim=True), zero)
    # ground-truth distribution terms phi(l, u) = 2^l - u
    params = torch.where(mask, torch.exp2(pl) - u, zero)
    denom = torch.clamp(params.sum(1, keepdim=True), min=1e-10)
    t1 = -params / denom + rho
    one_m = torch.clamp(1.0 - rho, min=1e-10)
    p1 = torch.where(mask, t1 / one_m, zero)
    s1 = p1.sum(1, keepdim=True)
    t2 = rho * (s1 - p1)
    p2 = torch.where(mask, t2 / one_m, zero)
    s2 = p2.sum(1, keepdim=True)
    lam = t1 + t2 + rho * (s2 - p2)
    hes = rho * (1.0 - rho)
    # queries with <= 1 document produce zero gradients
    keep = mask & ~(mask.sum(1, keepdim=True) <= 1)
    return torch.where(keep, lam, zero), torch.where(keep, hes, zero)


__all__ = ["LambdarankNDCG", "RankXENDCG", "RankingObjective",
           "default_label_gain", "max_dcg_at_k", "check_rank_labels"]
