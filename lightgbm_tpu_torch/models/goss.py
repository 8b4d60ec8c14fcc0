"""GOSS: Gradient-based One-Side Sampling (reference ``src/boosting/goss.hpp``).

Port of the JAX package's ``models/goss.py``: keeps the top ``top_rate``
fraction of rows by |g·h| and a random ``other_rate`` fraction of the rest,
scaling the sampled rows' gradients and hessians by
``(1-top_rate)/other_rate`` (``goss.hpp:103-152``), as device ops; the bag
is compacted like GBDT's when it keeps under 80% of the rows.
"""
from __future__ import annotations

import torch

from ..utils.random_gen import key_for_iteration, uniform
from .gbdt import GBDT


def goss_mask_from_importance(cfg, imp: torch.Tensor, u: torch.Tensor,
                              k_top: int):
    """(mask, amplify) from per-row |g·h| importance and a per-row uniform
    draw: EXACTLY ``k_top`` top rows plus an ``other_rate`` random sample
    of the rest, sampled rows amplified by ``(1-top_rate)/other_rate``.
    ``lax.top_k`` puts the lower index first among equal importances (the
    norm in early iterations), so the top rows come from a stable
    descending sort -- ``torch.topk``'s tie order is unspecified on CUDA."""
    n = imp.shape[0]
    top_idx = torch.sort(imp, descending=True, stable=True).indices[:k_top]
    is_top = torch.zeros(n, dtype=torch.bool, device=imp.device)
    is_top[top_idx] = True
    sampled = (u < cfg.other_rate) & ~is_top
    mask = (is_top | sampled).to(torch.float32)
    scale = (1.0 - cfg.top_rate) / max(cfg.other_rate, 1e-12)
    amplify = torch.where(sampled, torch.full_like(mask, scale),
                          torch.ones_like(mask))
    return mask, amplify


class GOSS(GBDT):
    def _bagging_weights(self, iteration, grad, hess):
        cfg = self.config
        n = self.train_data.num_data
        if cfg.top_rate + cfg.other_rate >= 1.0:
            return None, grad, hess
        # importance = sum over classes of |g*h| (goss.hpp:115)
        imp = torch.sum(torch.abs(grad * hess), dim=0)
        key = key_for_iteration(cfg.bagging_seed, iteration).to(self.device)
        mask, amplify = goss_mask_from_importance(
            cfg, imp, uniform(key, n), max(1, int(cfg.top_rate * n)))
        amplify = amplify[None, :]
        return mask, grad * amplify, hess * amplify

    # GOSS keeps top_rate + ~other_rate of the rows and re-bags EVERY
    # iteration: one re-gather an iteration, every grower pass O(kept rows)
    def _bag_subset_capacity(self):
        cfg = self.config
        if (cfg.top_rate + cfg.other_rate >= self._BAG_SUBSET_MAX_FRACTION
                or self._pmesh is not None):
            return None
        n = self.train_data.num_data
        k_top = max(1, int(cfg.top_rate * n))
        return self._capacity_with_margin(k_top + (n - k_top) * cfg.other_rate,
                                          n)

    def _bag_subset_refresh(self, iteration: int) -> bool:
        return True                 # gradient-based membership: every iter
