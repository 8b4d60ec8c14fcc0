"""Gradient/hessian histogram construction — the hot op.

Port of the JAX package's ``ops/histogram.py``.  A histogram is
``[F, B, 3]`` float32 with channels (sum g*m, sum h*m, sum m) per feature and
bin; bins >= B match nothing and are dropped.

Two entry points, each with a hand-written Hopper kernel
(``kernels/*.cu``, built by ``_build.py``) and a plain PyTorch version:

- ``build_histogram`` -> ``hist_full`` (the frontier's root histogram);
- ``build_histogram_leaves`` -> ``hist_leaves`` (per-leaf histograms of
  leaf-grouped row blocks, once per frontier round).

Both the kernels and the plain versions sum in float64 and round to float32
once: a float32 sum drifts with the summation order (atomics have none) by
~1e-4 when ~4,000 gradients cancel in a bin, while the float64 sum of
float32 values is exact or nearly so, so the kernel and the plain version
give the same bits and grow the same trees.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.  The only way to run the plain
version on the card is the explicit ``force_plain()`` context, which the
chip smoke test and the card-only tests use to compare the two.  Each kernel
wrapper counts its launches in ``launch_counts``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from . import _build

# kernel launches since the last reset_launch_counts(), by kernel name
launch_counts: Dict[str, int] = {name: 0 for name in _build.KERNELS}

# bytes of one CTA's privatised float64 histogram per (feature, bin)
_SMEM_PER_BIN = 24
# shared-memory budget of that histogram: F*B*24 bytes at F=28, B=256 is
# 172,032 bytes, so the main path runs two feature groups (16 + 12
# features, 98,304 bytes) and two CTAs fit an SM (228 KB)
SMEM_BUDGET_BYTES = 96 * 1024
# largest dynamic shared memory a CTA may opt into on Hopper
SMEM_MAX_BYTES = 227 * 1024
_THREADS = 512

_force_plain = False


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@contextlib.contextmanager
def force_plain():
    """Run the plain PyTorch versions even on CUDA tensors (for comparing a
    kernel with its plain version on the card; not a training parameter)."""
    global _force_plain
    prev = _force_plain
    _force_plain = True
    try:
        yield
    finally:
        _force_plain = prev


def _plain(t: torch.Tensor) -> bool:
    return t.device.type == "cpu" or _force_plain


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def build_histogram(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, mask: torch.Tensor, max_bin: int, *,
                    f_limit: Optional[int] = None) -> torch.Tensor:
    """``[F, B, 3]`` histogram of all rows of ``bins [N, NC]`` u8, over its
    first ``F = f_limit or NC`` columns."""
    if _plain(bins):
        return hist_full_plain(bins, grad, hess, mask, max_bin, f_limit=f_limit)
    return hist_full(bins, grad, hess, mask, max_bin, f_limit=f_limit)


def build_histogram_leaves(comb: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, mask: torch.Tensor,
                           block_leaf: torch.Tensor, num_slots: int,
                           max_bin: int, *, block_rows: int = 512,
                           f_limit: Optional[int] = None) -> torch.Tensor:
    """Per-slot histograms ``[num_slots, F, B, 3]`` of ``comb [C, NC]`` laid
    out as consecutive ``block_rows`` blocks, block ``i`` belonging to slot
    ``block_leaf[i]`` (need not be sorted; a slot with no block is zero)."""
    if _plain(comb):
        return hist_leaves_plain(comb, grad, hess, mask, block_leaf,
                                 num_slots, max_bin, block_rows=block_rows,
                                 f_limit=f_limit)
    return hist_leaves(comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                       block_rows=block_rows, f_limit=f_limit)


def subtract_histogram(parent: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
    """Sibling histogram via subtraction (reference ``FeatureHistogram::Subtract``,
    ``feature_histogram.hpp:79``)."""
    return parent - child


def unrolled_rank(sorted_vals: torch.Tensor, targets: torch.Tensor,
                  strict: bool) -> torch.Tensor:
    """Per-target count of entries in ``sorted_vals`` that are ``< target``
    (strict) or ``<= target`` — the JAX package's unrolled binary search,
    which in PyTorch is one ``searchsorted``."""
    return torch.searchsorted(sorted_vals.contiguous(), targets.contiguous(),
                              right=not strict).to(torch.int32)


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' yardstick on the card)
# --------------------------------------------------------------------------

def _n_feat(ncols: int, f_limit: Optional[int]) -> int:
    return min(f_limit, ncols) if f_limit is not None else ncols


def hist_full_plain(bins, grad, hess, mask, max_bin, f_limit=None):
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    b = bins[:, :f].long()
    gh = torch.stack([grad * mask, hess * mask, mask], dim=-1)        # [N, 3]
    keep = b < max_bin
    flat = b + max_bin * torch.arange(f, device=b.device)[None, :]
    vals = gh.double()[:, None, :].expand(n, f, 3)
    out = torch.zeros(f * max_bin, 3, dtype=torch.float64, device=b.device)
    out.index_add_(0, flat[keep], vals[keep])
    return out.float().view(f, max_bin, 3)


def hist_leaves_plain(comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                      block_rows=512, f_limit=None):
    n, nc = comb.shape
    f = _n_feat(nc, f_limit)
    row_leaf = block_leaf.long().repeat_interleave(block_rows)[:n]
    b = comb[:, :f].long()
    slot_ok = (row_leaf >= 0) & (row_leaf < num_slots)
    keep = (b < max_bin) & slot_ok[:, None]
    flat = ((row_leaf[:, None] * f
             + torch.arange(f, device=b.device)[None, :]) * max_bin + b)
    gh = torch.stack([grad * mask, hess * mask, mask], dim=-1)        # [C, 3]
    vals = gh.double()[:, None, :].expand(n, f, 3)
    out = torch.zeros(num_slots * f * max_bin, 3, dtype=torch.float64,
                      device=b.device)
    out.index_add_(0, flat[keep], vals[keep])
    return out.float().view(num_slots, f, max_bin, 3)


# --------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_rows(name, mat, grad, hess, mask):
    dev = mat.device
    _check(dev.type == "cuda", f"{name}: tensors must be on a CUDA device")
    _check(mat.dtype == torch.uint8 and mat.dim() == 2 and mat.is_contiguous(),
           f"{name}: bins must be a contiguous 2-D uint8 tensor")
    n = mat.shape[0]
    for label, t in (("grad", grad), ("hess", hess), ("mask", mask)):
        _check(t.device == dev and t.dtype == torch.float32 and t.dim() == 1
               and t.shape[0] == n and t.is_contiguous(),
               f"{name}: {label} must be a contiguous float32 [{n}] tensor "
               f"on {dev}")


def _feature_group(f: int, max_bin: int) -> int:
    per_feat = _SMEM_PER_BIN * max_bin
    _check(per_feat <= SMEM_MAX_BYTES,
           f"max_bin={max_bin} needs {per_feat} bytes of shared memory per "
           f"feature, above {SMEM_MAX_BYTES}")
    return max(1, min(f, max(SMEM_BUDGET_BYTES, per_feat) // per_feat))


def _ctas(dev: torch.device, fg: int, max_bin: int) -> int:
    """CTAs that fit the card at once: SMs times CTAs per SM by shared
    memory (at most 2 with 512 threads each)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, min(2, (228 * 1024)
                        // (_SMEM_PER_BIN * fg * max_bin + 1024)))
    return sms * per_sm


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.lgbt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def hist_full(bins, grad, hess, mask, max_bin, f_limit=None):
    """``[F, B, 3]`` histogram by the ``hist_full`` CUDA kernel."""
    _check_rows("hist_full", bins, grad, hess, mask)
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    out = torch.zeros(f, max_bin, 3, dtype=torch.float64, device=bins.device)
    if n == 0 or f == 0:
        return out.float()
    fg = _feature_group(f, max_bin)
    grid_x = max(1, min(_ctas(bins.device, fg, max_bin), -(-n // _THREADS)))
    lib = _build.load("hist_full")
    rc = lib.hist_full_launch(
        bins.device.index, bins.data_ptr(), n, ncols, f, max_bin,
        grad.data_ptr(), hess.data_ptr(), mask.data_ptr(), out.data_ptr(),
        fg, grid_x, _THREADS, torch.cuda.current_stream(bins.device).cuda_stream)
    _raise_on(lib, "hist_full", rc)
    launch_counts["hist_full"] += 1
    return out.float()


def hist_leaves(comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                block_rows=512, f_limit=None):
    """``[num_slots, F, B, 3]`` histograms by the ``hist_leaves`` CUDA
    kernel."""
    _check_rows("hist_leaves", comb, grad, hess, mask)
    c, nc = comb.shape
    f = _n_feat(nc, f_limit)
    _check(block_rows > 0 and c % block_rows == 0,
           f"hist_leaves: rows ({c}) must be a multiple of block_rows "
           f"({block_rows})")
    nb = c // block_rows
    _check(block_leaf.device == comb.device and block_leaf.dtype == torch.int32
           and block_leaf.dim() == 1 and block_leaf.shape[0] == nb
           and block_leaf.is_contiguous(),
           f"hist_leaves: block_leaf must be a contiguous int32 [{nb}] "
           f"tensor on {comb.device}")
    out = torch.zeros(num_slots, f, max_bin, 3, dtype=torch.float64,
                      device=comb.device)
    if nb == 0 or f == 0 or num_slots == 0:
        return out.float()
    fg = _feature_group(f, max_bin)
    n_groups = -(-f // fg)
    ctas = _ctas(comb.device, fg, max_bin)
    bpc = max(1, -(-nb * n_groups // ctas))
    lib = _build.load("hist_leaves")
    rc = lib.hist_leaves_launch(
        comb.device.index, comb.data_ptr(), c, nc, f, max_bin,
        grad.data_ptr(), hess.data_ptr(), mask.data_ptr(),
        block_leaf.data_ptr(), block_rows, num_slots, out.data_ptr(), fg,
        bpc, _THREADS, torch.cuda.current_stream(comb.device).cuda_stream)
    _raise_on(lib, "hist_leaves", rc)
    launch_counts["hist_leaves"] += 1
    return out.float()
