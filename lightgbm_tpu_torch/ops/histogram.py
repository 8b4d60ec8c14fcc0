"""Gradient/hessian histogram construction — the hot op.

Port of the JAX package's ``ops/histogram.py``.  A histogram is
``[F, B, 3]`` float32 with channels (sum g*m, sum h*m, sum m) per feature and
bin; bins >= B match nothing and are dropped.

Two methods, each with a full-pass and a per-leaf entry point, each entry
point with a hand-written Hopper kernel (``kernels/*.cu``, built by
``_build.py``) and a plain PyTorch version:

- ``method="atomic"`` (the default; ``force_col_wise``):
  ``build_histogram`` -> ``hist_full``, ``build_histogram_leaves`` ->
  ``hist_leaves``: rows scattered into float64 shared-memory histograms.
  The counterpart of the JAX package's scatter method, the card's
  counterpart of a known winner.
- ``method="onehot"`` (``force_row_wise``): ``hist_onehot_full`` and
  ``hist_onehot_leaves``, the tensor-core port of the Pallas one-hot
  kernels: ``gh · onehotᵀ`` with the ``[6, N]`` bf16 (hi, lo) split of
  ``(g·m, h·m, m)``, the one-hot built by the ``variant``'s body
  (``onehot_variants.py``), in the ``featmajor`` or ``rowmajor`` layout.
  Every variant computes the same function, so they share one plain
  version per entry point.

The frontier calls ``build_histogram`` for its root histogram and
``build_histogram_leaves`` once per round.  Every kernel and plain version
sums in float64 and rounds to float32 once: a float32 sum drifts with the
summation order (atomics have none) by ~1e-4 when ~4,000 gradients cancel
in a bin, while the float64 sum of float32 (or bf16) values is exact or
nearly so, so a kernel and its plain version give the same bits in
practice and grow the same trees.

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
from . import onehot_variants as ov

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

METHODS = ("atomic", "onehot")
LAYOUTS = ("featmajor", "rowmajor")


def build_histogram(bins: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, mask: torch.Tensor, max_bin: int, *,
                    f_limit: Optional[int] = None, method: str = "atomic",
                    variant: str = "base",
                    layout: str = "featmajor") -> torch.Tensor:
    """``[F, B, 3]`` histogram of all rows of ``bins [N, NC]`` u8, over its
    first ``F = f_limit or NC`` columns.  ``variant`` and ``layout`` select
    the one-hot kernel's body and how it reads the bins; the atomic method
    ignores them."""
    if method == "onehot":
        _onehot_spec(variant, max_bin, layout)
        if _plain(bins):
            return hist_onehot_full_plain(bins, grad, hess, mask, max_bin,
                                          f_limit=f_limit)
        return hist_onehot_full(bins, grad, hess, mask, max_bin,
                                f_limit=f_limit, variant=variant,
                                layout=layout)
    _check(method == "atomic", f"unknown histogram method {method!r}; "
           f"known: {', '.join(METHODS)}")
    if _plain(bins):
        return hist_full_plain(bins, grad, hess, mask, max_bin, f_limit=f_limit)
    return hist_full(bins, grad, hess, mask, max_bin, f_limit=f_limit)


def build_histogram_leaves(comb: torch.Tensor, grad: torch.Tensor,
                           hess: torch.Tensor, mask: torch.Tensor,
                           block_leaf: torch.Tensor, num_slots: int,
                           max_bin: int, *, block_rows: int = 512,
                           f_limit: Optional[int] = None,
                           method: str = "atomic",
                           variant: str = "base") -> torch.Tensor:
    """Per-slot histograms ``[num_slots, F, B, 3]`` of ``comb [C, NC]`` laid
    out as consecutive ``block_rows`` blocks, block ``i`` belonging to slot
    ``block_leaf[i]`` (need not be sorted; a slot with no block is zero)."""
    if method == "onehot":
        _onehot_spec(variant, max_bin, "rowmajor")
        if _plain(comb):
            return hist_onehot_leaves_plain(
                comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                block_rows=block_rows, f_limit=f_limit)
        return hist_onehot_leaves(comb, grad, hess, mask, block_leaf,
                                  num_slots, max_bin, block_rows=block_rows,
                                  f_limit=f_limit, variant=variant)
    _check(method == "atomic", f"unknown histogram method {method!r}; "
           f"known: {', '.join(METHODS)}")
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


def _full_plain(bins, vals, max_bin, f_limit):
    """Sum the float64 row values ``vals [N, 3]`` per (feature, bin) of the
    first ``f`` columns; bins >= ``max_bin`` are dropped."""
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    b = bins[:, :f].long()
    keep = b < max_bin
    flat = b + max_bin * torch.arange(f, device=b.device)[None, :]
    out = torch.zeros(f * max_bin, 3, dtype=torch.float64, device=b.device)
    out.index_add_(0, flat[keep], vals[:, None, :].expand(n, f, 3)[keep])
    return out.float().view(f, max_bin, 3)


def _leaves_plain(comb, vals, block_leaf, num_slots, max_bin, block_rows,
                  f_limit):
    """Per-slot ``_full_plain``: row ``r`` belongs to slot
    ``block_leaf[r // block_rows]``; a slot outside ``[0, num_slots)``
    matches nothing."""
    n, nc = comb.shape
    f = _n_feat(nc, f_limit)
    row_leaf = block_leaf.long().repeat_interleave(block_rows)[:n]
    b = comb[:, :f].long()
    slot_ok = (row_leaf >= 0) & (row_leaf < num_slots)
    keep = (b < max_bin) & slot_ok[:, None]
    flat = ((row_leaf[:, None] * f
             + torch.arange(f, device=b.device)[None, :]) * max_bin + b)
    out = torch.zeros(num_slots * f * max_bin, 3, dtype=torch.float64,
                      device=b.device)
    out.index_add_(0, flat[keep], vals[:, None, :].expand(n, f, 3)[keep])
    return out.float().view(num_slots, f, max_bin, 3)


def _gh_rows(grad, hess, mask):
    """``[N, 3]`` float64 of the float32 products (g·m, h·m, m)."""
    return torch.stack([grad * mask, hess * mask, mask], dim=-1).double()


def _pair_rows(grad, hess, mask):
    """``[N, 3]`` float64 of the bf16 pair ``hi + lo`` of (g·m, h·m, m):
    the row values every one-hot variant sums."""
    gh6 = ov.split_bf16_pair(grad, hess, mask).double()
    return (gh6[:3] + gh6[3:]).t()


def hist_full_plain(bins, grad, hess, mask, max_bin, f_limit=None):
    return _full_plain(bins, _gh_rows(grad, hess, mask), max_bin, f_limit)


def hist_leaves_plain(comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                      block_rows=512, f_limit=None):
    return _leaves_plain(comb, _gh_rows(grad, hess, mask), block_leaf,
                         num_slots, max_bin, block_rows, f_limit)


def hist_onehot_full_plain(bins, grad, hess, mask, max_bin, f_limit=None):
    """The function of every one-hot variant in both layouts: the bf16 pair
    summed per (feature, bin) in float64 and rounded once.  A non-finite
    value reaches only its own bins here; in the kernels (and the Pallas
    ones) it spreads over its channel, since the one-hot's zeros times it
    are NaN."""
    return _full_plain(bins, _pair_rows(grad, hess, mask), max_bin, f_limit)


def hist_onehot_leaves_plain(comb, grad, hess, mask, block_leaf, num_slots,
                             max_bin, block_rows=512, f_limit=None):
    return _leaves_plain(comb, _pair_rows(grad, hess, mask), block_leaf,
                         num_slots, max_bin, block_rows, f_limit)


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


# --------------------------------------------------------------------------
# one-hot kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

# the kernels' geometry (kernels/onehot_common.cuh): 128-thread CTAs of 512
# output lanes that stage 128 rows at a time
_OH_BLOCK_LANES = 512
_OH_CHUNK = 128
_OH_CTAS_PER_SM = 4


def _onehot_spec(variant: str, max_bin: int, layout: str) -> ov.VariantSpec:
    """The variant's spec, after the checks every one-hot entry point makes
    (the JAX kernels' own: an unknown layout, or a variant that cannot
    serve the width, is an error; ``resolve`` picks a variant first)."""
    _check(layout in LAYOUTS, f"unknown histogram layout {layout!r}")
    _check(variant in ov.VARIANTS, f"unknown hist_variant {variant!r}; "
           f"known: {', '.join(ov.VARIANT_NAMES)}")
    spec = ov.VARIANTS[variant]
    if spec.kernel_id is None:
        ov.resolve(variant, max_bin)               # raises NotPortedError
    _check(0 < max_bin <= 256 and spec.supports(max_bin),
           f"hist variant {variant!r} does not support max_bin={max_bin} "
           "(resolve the variant with onehot_variants.resolve first)")
    return spec


def _onehot_geometry(spec, f, max_bin):
    """(Bp, lanes, log2 of the lanes per feature, most features one CTA's
    512 lanes read)."""
    Bp = ov.padded_bins(max_bin)
    lanes = ov.feat_geometry(spec, f, max_bin, Bp)[1]
    lpf = ov.lanes_per_feature(spec, max_bin)
    return Bp, lanes, lpf.bit_length() - 1, min(f, _OH_BLOCK_LANES // lpf)


def _onehot_ctas(dev: torch.device) -> int:
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            * _OH_CTAS_PER_SM)


def hist_onehot_full(bins, grad, hess, mask, max_bin, f_limit=None,
                     variant="base", layout="featmajor"):
    """``[F, B, 3]`` histogram by the ``onehot_full`` CUDA kernel: the
    variant's one-hot body, reading a ``[F, N]`` transposed copy of the bins
    (``featmajor``, as the Pallas path does) or the ``[N, NC]`` matrix as
    stored (``rowmajor``)."""
    _check_rows("onehot_full", bins, grad, hess, mask)
    spec = _onehot_spec(variant, max_bin, layout)
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    Bp, lanes, lpf_log2, nf_max = _onehot_geometry(spec, f, max_bin)
    out = torch.zeros(6, lanes, dtype=torch.float64, device=bins.device)
    if n > 0 and f > 0:
        gh6 = ov.split_bf16_pair(grad, hess, mask)
        if layout == "featmajor":
            src, ld, lay = bins[:, :f].t().contiguous(), n, 0
        else:
            src, ld, lay = bins, ncols, 1
        chunks = -(-n // _OH_CHUNK)
        nlb = -(-lanes // _OH_BLOCK_LANES)
        splits = max(1, min(chunks, -(-_onehot_ctas(bins.device) // nlb)))
        cps = -(-chunks // splits)
        lib = _build.load("onehot_full")
        rc = lib.onehot_full_launch(
            bins.device.index, src.data_ptr(), ld, n, f, lay,
            gh6.data_ptr(), out.data_ptr(), spec.kernel_id, lpf_log2, lanes,
            nf_max, cps, -(-chunks // cps),
            torch.cuda.current_stream(bins.device).cuda_stream)
        _raise_on(lib, "onehot_full", rc)
        launch_counts["onehot_full"] += 1
    return ov.finish_hist(out, f, max_bin, Bp, spec).float()


def hist_onehot_leaves(comb, grad, hess, mask, block_leaf, num_slots,
                       max_bin, block_rows=512, f_limit=None,
                       variant="base"):
    """``[num_slots, F, B, 3]`` histograms by the ``onehot_leaves`` CUDA
    kernel, reading ``comb [C, NC]`` as the frontier gathers it."""
    _check_rows("onehot_leaves", comb, grad, hess, mask)
    spec = _onehot_spec(variant, max_bin, "rowmajor")
    c, nc = comb.shape
    f = _n_feat(nc, f_limit)
    _check(block_rows > 0 and block_rows % _OH_CHUNK == 0
           and c % block_rows == 0,
           f"onehot_leaves: rows ({c}) must be a multiple of block_rows "
           f"({block_rows}), itself a multiple of {_OH_CHUNK}")
    nb = c // block_rows
    _check(block_leaf.device == comb.device and block_leaf.dtype == torch.int32
           and block_leaf.dim() == 1 and block_leaf.shape[0] == nb
           and block_leaf.is_contiguous(),
           f"onehot_leaves: block_leaf must be a contiguous int32 [{nb}] "
           f"tensor on {comb.device}")
    Bp, lanes, lpf_log2, nf_max = _onehot_geometry(spec, f, max_bin)
    out = torch.zeros(num_slots, 6, lanes, dtype=torch.float64,
                      device=comb.device)
    if nb > 0 and f > 0 and num_slots > 0:
        gh6 = ov.split_bf16_pair(grad, hess, mask)
        nlb = -(-lanes // _OH_BLOCK_LANES)
        bpc = max(1, -(-nb * nlb // _onehot_ctas(comb.device)))
        lib = _build.load("onehot_leaves")
        rc = lib.onehot_leaves_launch(
            comb.device.index, comb.data_ptr(), nc, c, f, gh6.data_ptr(),
            block_leaf.data_ptr(), block_rows, num_slots, out.data_ptr(),
            spec.kernel_id, lpf_log2, lanes, nf_max, bpc,
            torch.cuda.current_stream(comb.device).cuda_stream)
        _raise_on(lib, "onehot_leaves", rc)
        launch_counts["onehot_leaves"] += 1
    return ov.finish_hist(out, f, max_bin, Bp, spec).float()
