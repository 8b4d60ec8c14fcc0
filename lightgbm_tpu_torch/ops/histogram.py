"""Gradient/hessian histogram construction — the hot op.

Port of the JAX package's ``ops/histogram.py``.  A histogram is
``[F, B, 3]`` float32 with channels (sum g*m, sum h*m, sum m) per feature and
bin; bins >= B match nothing and are dropped.  Bins are ``uint8`` or
``uint16`` (a feature of more than 256 bins, up to 65,536, or an EFB
bundle up to 4,096 bins wide); every kernel takes both, as a second
instantiation of its template on the bin type, at every width a u16 bin
reaches.

Two methods, each with a full-pass and a per-leaf entry point, each entry
point with a hand-written Hopper kernel (``kernels/*.cu``, built by
``_build.py``) and a plain PyTorch version:

- ``method="atomic"`` (the default; ``force_col_wise``):
  ``build_histogram`` -> ``hist_full``, ``build_histogram_leaves`` ->
  ``hist_leaves``: rows scattered into float64 shared-memory histograms
  with no atomics -- each warp owning whole features (``owned``, the
  main path at B = 256), or at wide bins every warp taking (step,
  feature) items whose lanes a warp sort groups by bin (``dealt``; the
  plan picks, ``ATOMIC_DESIGNS``) -- one float64 partial per CTA (per
  slot run for the leaves) summed by a second kernel in a fixed order.
  Where one feature's histogram does not fit a CTA (above ~8,900 bins),
  the plan splits each feature's bins into bin tiles, a grid axis beside
  the feature groups (``atomic_geometry``).
  The counterpart of the JAX package's scatter method, the card's
  counterpart of a known winner.
- ``method="onehot"`` (``force_row_wise``): ``hist_onehot_full`` and
  ``hist_onehot_leaves``, the tensor-core port of the Pallas one-hot
  kernels: ``gh · onehotᵀ`` with the ``[6, N]`` bf16 (hi, lo) split of
  ``(g·m, h·m, m)``, the one-hot built by the ``variant``'s body
  (``onehot_variants.py``), in the ``featmajor`` or ``rowmajor`` layout.
  The seven bf16-pair variants compute the same function and share one
  plain version per entry point.  ``int8`` first runs the quantize kernel
  (``quantize_int8``: one launch that reads grad, hess and mask) over the
  Pallas kernels' row blocks, then
  multiplies int8 by int8 with exact int32 sums; it has plain versions of
  its own (``hist_onehot_int8_*_plain``).  ``hist_onehot_bench`` is the
  shootout shell's entry (``onehot_variants.make_bench_kernel``).  Above
  256 bins (u16) four bodies serve: ``base``, ``i16cmp``, ``staged`` and
  ``int8`` (``VariantSpec.supports``), in the bucketed design (rows
  sorted by their 128-lane bucket, so that a warp multiplies only the
  rows whose bins fall in its lanes; ``onehot_plan`` picks it at u16
  widths, and ``onehot_design`` asks for the dense one).  The per-leaf
  entry takes the one-hot kernel only inside the JAX package's cut
  (``onehot_leaves_fits``); outside it, the atomic kernel, as the JAX
  package takes its scatter there.

A non-finite value makes its whole channel NaN in the one-hot product
(``0·NaN`` and ``0·inf`` are NaN) -- in a full pass everywhere, per leaf
in its slot -- and the plain one-hot versions give the same NaNs.

The frontier calls ``build_histogram`` for its root histogram and
``build_histogram_leaves`` once per round.  Every kernel and plain version
sums in float64 and rounds to float32 once: a float32 sum drifts with the
summation order by ~1e-4 when ~4,000 gradients cancel
in a bin, while the float64 sum of float32 (or bf16) values is exact or
nearly so, so a kernel and its plain version give the same bits in
practice and grow the same trees.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.  The only way to run the plain
version on the card is the explicit ``force_plain()`` context, which the
chip smoke test and the card-only tests use to compare the two.  Each kernel
wrapper counts its launches in ``launch_counts``, and ``build_histogram``
and ``build_histogram_leaves`` count the bytes each call moves in
``hist_bytes`` (the cost record of the observability plane).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import torch

from . import _build
from . import onehot_variants as ov

# kernel launches since the last reset_launch_counts(), by kernel name:
# one per library, and the shootout shell's own entry into onehot_full's
launch_counts: Dict[str, int] = {name: 0 for name in
                                 (*_build.KERNELS, "onehot_bench")}

# bytes the build_histogram* calls have read and written, by wrapper
# ("full", "leaves"), counted from each
# call's shape on the CPU and the card alike by the byte rule of the
# kernels' bound: each input byte read once (the F bin columns of every
# row; grad, hess and mask; the leaves' block map), each output bin
# written once (three float32)
hist_bytes: Dict[str, int] = {"full": 0, "leaves": 0}

# tolerance of every one-hot variant against the exact scatter (the JAX
# package's HIST_PARITY_TOL): the bf16 pair's, and int8's, own error
HIST_PARITY_TOL = 5e-4

# largest dynamic shared memory a CTA may opt into on Hopper
SMEM_MAX_BYTES = 227 * 1024
# the widest histogram the atomic kernels take: every u16 bin
ATOMIC_MAX_BIN = 65536

_force_plain = False
# the atomic kernels' two designs of the update, in the plan's numbering
# (kernels/hist_common.cuh), and the one atomic_design() asks for
ATOMIC_DESIGNS = ("owned", "dealt")
_atomic_design: Optional[str] = None
# the fewest bin tiles atomic_tiles() asks the plan for (1: as the width
# needs)
_atomic_min_tiles = 1
# the one-hot kernels' two designs, in the kernels' numbering
# (kernels/onehot_bucket.cuh): dense, every warp over every row of its
# lanes' features; bucketed, the rows sorted by their 128-lane bucket
# (u16 bins only); and the one onehot_design() asks for
ONEHOT_DESIGNS = ("dense", "bucketed")
_onehot_design: Optional[str] = None


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


@contextlib.contextmanager
def atomic_design(design: str):
    """Plan the atomic kernels in this design of the update (one of
    ``ATOMIC_DESIGNS``) in place of the plan's own choice, to time one
    design against the other on the card; not a training parameter."""
    global _atomic_design
    _check(design in ATOMIC_DESIGNS, f"unknown atomic design {design!r}; "
           f"known: {', '.join(ATOMIC_DESIGNS)}")
    prev = _atomic_design
    _atomic_design = design
    try:
        yield
    finally:
        _atomic_design = prev


@contextlib.contextmanager
def atomic_tiles(tiles: int):
    """Plan the atomic kernels with at least this many bin tiles a feature
    even where the width needs fewer, to test the tiled path against the
    untiled one on the card; not a training parameter."""
    global _atomic_min_tiles
    _check(tiles >= 1, f"bin tiles must be at least 1, not {tiles}")
    prev = _atomic_min_tiles
    _atomic_min_tiles = tiles
    try:
        yield
    finally:
        _atomic_min_tiles = prev


@contextlib.contextmanager
def onehot_design(design: str):
    """Run the one-hot kernels in this design (one of
    ``ONEHOT_DESIGNS``) in place of ``onehot_plan``'s choice, to time or
    test one design against the other on the card; a width the design
    does not serve is refused (``onehot_plan``); not a training
    parameter."""
    global _onehot_design
    _check(design in ONEHOT_DESIGNS, f"unknown one-hot design {design!r}; "
           f"known: {', '.join(ONEHOT_DESIGNS)}")
    prev = _onehot_design
    _onehot_design = design
    try:
        yield
    finally:
        _onehot_design = prev


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
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    hist_bytes["full"] += (bins.element_size() * n * f + 12 * n
                           + f * max_bin * 12)
    if method == "onehot":
        _onehot_spec(variant, max_bin, layout)
        if _plain(bins) and variant == "int8":
            return hist_onehot_int8_full_plain(bins, grad, hess, mask,
                                               max_bin, f_limit=f_limit,
                                               layout=layout)
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
    ``block_leaf[i]`` (need not be sorted; a slot with no block is zero).
    ``method="onehot"`` outside ``onehot_leaves_fits`` takes the atomic
    method, on the CPU and on the card alike."""
    c, f = comb.shape[0], _n_feat(comb.shape[1], f_limit)
    hist_bytes["leaves"] += (comb.element_size() * c * f + 12 * c
                             + 4 * block_leaf.numel()
                             + num_slots * f * max_bin * 12)
    if method == "onehot" and not onehot_leaves_fits(f, num_slots, max_bin):
        method = "atomic"
    if method == "onehot":
        _onehot_spec(variant, max_bin, "rowmajor")
        if _plain(comb) and variant == "int8":
            return hist_onehot_int8_leaves_plain(
                comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                block_rows=block_rows, f_limit=f_limit)
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


# the JAX package's cut for its Pallas leaves kernel
# (lightgbm_tpu/ops/histogram.py::build_histogram_leaves, the constants
# _PALLAS_ROWMAJOR_MAX_LANES and _PALLAS_LEAFACC_BYTES): at most this many
# lanes f * Bp, and a [num_slots, 6, f * Bp] float32 accumulator of at
# most this many bytes; above either it takes its scatter
ONEHOT_LEAVES_MAX_LANES = 32768
ONEHOT_LEAVES_ACC_BYTES = 48 * 1024 * 1024


def onehot_leaves_fits(f: int, num_slots: int, max_bin: int) -> bool:
    """Whether the per-leaf histograms of ``f`` features at ``max_bin``
    over ``num_slots`` slots take the one-hot kernel under
    ``method="onehot"``: the JAX package's cut, on its lanes ``f * Bp``
    (whatever the variant's lane packing)."""
    lanes = f * ov.padded_bins(max_bin)
    return (lanes <= ONEHOT_LEAVES_MAX_LANES
            and num_slots * 6 * lanes * 4 <= ONEHOT_LEAVES_ACC_BYTES)


def accumulate_histogram(acc: torch.Tensor, bins: torch.Tensor,
                         grad: torch.Tensor, hess: torch.Tensor,
                         mask: torch.Tensor, max_bin: int, *,
                         method: str = "atomic",
                         variant: str = "base") -> torch.Tensor:
    """Block-accumulating entry point: ``acc + build_histogram(block)``
    (the JAX package's ``accumulate_histogram``).  The out-of-core grower
    (``stream/``) folds each streamed row block into a running float32
    ``[F, B, 3]`` accumulator with it: on a CUDA block that is the K1
    kernel (``hist_full``, or ``onehot_full`` featmajor under
    ``method="onehot"``), on a CPU block its plain version.  Accumulation
    is block-major, so the float32 adds reassociate against one full pass
    (the sharded learners' noise class, ~2^-23 relative an add)."""
    return acc + build_histogram(bins, grad, hess, mask, max_bin,
                                 method=method, variant=variant)


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


def _row_slots(n, block_leaf, num_slots, block_rows, device):
    """``(slot [N] int64, ok [N] bool)``: row ``r``'s slot
    ``block_leaf[r // block_rows]`` (0 for a full pass, ``block_leaf`` None)
    and whether it lies in ``[0, num_slots)``; a row outside matches
    nothing."""
    if block_leaf is None:
        return (torch.zeros(n, dtype=torch.int64, device=device),
                torch.ones(n, dtype=torch.bool, device=device))
    row_leaf = block_leaf.long().repeat_interleave(block_rows)[:n]
    ok = (row_leaf >= 0) & (row_leaf < num_slots)
    return torch.where(ok, row_leaf, 0), ok


def _scatter(b, vals, rows_ok, slot, num_slots, max_bin):
    """``[num_slots, f, B, C]`` float64: the row values ``vals [N, C]``
    summed per (slot, feature, bin) of ``b [N, f]`` over the rows in
    ``rows_ok``; bins >= ``max_bin`` are dropped."""
    n, f = b.shape
    c = vals.shape[1]
    keep = (b < max_bin) & rows_ok[:, None]
    flat = ((slot[:, None] * f + torch.arange(f, device=b.device)[None, :])
            * max_bin + b)
    out = torch.zeros(num_slots * f * max_bin, c, dtype=torch.float64,
                      device=b.device)
    out.index_add_(0, flat[keep], vals[:, None, :].expand(n, f, c)[keep])
    return out.view(num_slots, f, max_bin, c)


def _pair_plain(b, gh6, slot, ok, num_slots, max_bin):
    """The function of every bf16-pair variant: the pair ``hi + lo`` summed
    per (slot, feature, bin) in float64.  A row that holds a non-finite
    value (rare) adds instead its own dense product ``hi·onehot +
    lo·onehot`` over every (feature, bin) of its slot, as the one-hot
    product gives it: ``0·NaN`` and ``0·inf`` are NaN, so the NaN covers
    its channel (an infinite ``x`` has a NaN ``lo = x - hi``)."""
    pair = gh6.double()
    hi, lo = pair[:3].t(), pair[3:].t()
    bad = ~torch.isfinite(pair).all(0)
    out = _scatter(b, hi + lo, ok & ~bad, slot, num_slots, max_bin)
    rows = torch.nonzero(bad & ok)[:, 0]
    if rows.numel():
        onehot = (b[rows, :, None] == torch.arange(max_bin, device=b.device)
                  ).double()[..., None]                     # [m, f, B, 1]
        dense = (hi[rows, None, None, :] * onehot
                 + lo[rows, None, None, :] * onehot)        # [m, f, B, 3]
        out.index_add_(0, slot[rows], dense)
    return out


def _int8_plain(b, rows, block_rows, slot, ok, num_slots, max_bin):
    """The int8 variant's function: ``rows [3, N]`` quantized per block of
    ``block_rows`` rows (``quantize_int8_blocks_plain``), the exact integer
    sums per bin folded by the block's scales in float64: ``hi = Σq1·s1``,
    ``lo = Σq2·s2 + Σq3·s3`` (each ``q·s`` is exact in float64).  A block
    whose scales are not all finite (a non-finite value in it) adds instead
    its dense product ``acc·s`` over every (feature, bin) of its slot, zero
    sums included, as the kernels fold it."""
    n = b.shape[0]
    q, s = ov.quantize_int8_blocks_plain(rows, block_rows)
    sd = s.double()
    blk = torch.arange(n, device=b.device) // block_rows
    v = q.t().double() * sd[blk]                            # [N, 9]
    vals = v[:, 0:3] + (v[:, 3:6] + v[:, 6:9])
    bad_blk = ~torch.isfinite(s).all(1)
    out = _scatter(b, vals, ok & ~bad_blk[blk], slot, num_slots, max_bin)
    for j in torch.nonzero(bad_blk)[:, 0].tolist():
        r0, r1 = j * block_rows, min((j + 1) * block_rows, n)
        if not bool(ok[r0]):
            continue
        acc = _scatter(b[r0:r1], q[:, r0:r1].t().double(),
                       torch.ones(r1 - r0, dtype=torch.bool, device=b.device),
                       torch.zeros(r1 - r0, dtype=torch.int64,
                                   device=b.device), 1, max_bin)[0]
        sj = sd[j]
        out[int(slot[r0])] += (acc[..., 0:3] * sj[0:3]
                               + (acc[..., 3:6] * sj[3:6]
                                  + acc[..., 6:9] * sj[6:9]))
    return out


def _gh_rows(grad, hess, mask):
    """``[N, 3]`` float64 of the float32 products (g·m, h·m, m)."""
    return torch.stack([grad * mask, hess * mask, mask], dim=-1).double()


def widen_bins(t: torch.Tensor) -> torch.Tensor:
    """Bins as int64, for comparing and indexing: ``uint16`` is a storage
    type in PyTorch (no ``<`` or ``+``), so its bits go through ``int16``
    and a mask, which every device supports; an ``int16`` view of u16 bins
    (``movable_bins``) widens the same way."""
    if t.dtype in (torch.uint16, torch.int16):
        return t.view(torch.int16).long() & 0xFFFF
    return t.long()


def movable_bins(t: torch.Tensor) -> torch.Tensor:
    """A view of bins that every device can gather, index and concatenate:
    ``uint16`` as ``int16`` (the same bits; view back with
    ``.view(torch.uint16)``), ``uint8`` as it is."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a ``uint8`` or ``uint16`` bin matrix, same dtype."""
    return movable_bins(t)[idx].view(t.dtype)


def _full_rows(bins, f_limit):
    n, ncols = bins.shape
    return (widen_bins(bins[:, :_n_feat(ncols, f_limit)]),
            *_row_slots(n, None, 1, 1, bins.device))


def _leaves_rows(comb, block_leaf, num_slots, block_rows, f_limit):
    n, nc = comb.shape
    return (widen_bins(comb[:, :_n_feat(nc, f_limit)]),
            *_row_slots(n, block_leaf, num_slots, block_rows, comb.device))


def hist_full_plain(bins, grad, hess, mask, max_bin, f_limit=None):
    b, slot, ok = _full_rows(bins, f_limit)
    return _scatter(b, _gh_rows(grad, hess, mask), ok, slot, 1,
                    max_bin)[0].float()


def hist_leaves_plain(comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                      block_rows=512, f_limit=None):
    b, slot, ok = _leaves_rows(comb, block_leaf, num_slots, block_rows,
                               f_limit)
    return _scatter(b, _gh_rows(grad, hess, mask), ok, slot, num_slots,
                    max_bin).float()


def hist_onehot_full_plain(bins, grad, hess, mask, max_bin, f_limit=None):
    """The function of every bf16-pair variant in both layouts: the bf16
    pair summed per (feature, bin) in float64 and rounded once; a
    non-finite value makes its channel NaN, as in the kernels."""
    b, slot, ok = _full_rows(bins, f_limit)
    return _pair_plain(b, ov.split_bf16_pair(grad, hess, mask), slot, ok, 1,
                       max_bin)[0].float()


def hist_onehot_leaves_plain(comb, grad, hess, mask, block_leaf, num_slots,
                             max_bin, block_rows=512, f_limit=None):
    b, slot, ok = _leaves_rows(comb, block_leaf, num_slots, block_rows,
                               f_limit)
    return _pair_plain(b, ov.split_bf16_pair(grad, hess, mask), slot, ok,
                       num_slots, max_bin).float()


def hist_onehot_int8_full_plain(bins, grad, hess, mask, max_bin, f_limit=None,
                                layout="featmajor"):
    """The int8 variant's full pass, quantized in the layout's blocks (the
    JAX package's ``BR``, ``onehot_variants.pallas_block_rows``)."""
    b, slot, ok = _full_rows(bins, f_limit)
    br = ov.pallas_block_rows("int8", layout, b.shape[0], b.shape[1],
                              max_bin)
    return _int8_plain(b, ov.prep_f32(grad, hess, mask), br, slot, ok, 1,
                       max_bin)[0].float()


def hist_onehot_int8_leaves_plain(comb, grad, hess, mask, block_leaf,
                                  num_slots, max_bin, block_rows=512,
                                  f_limit=None):
    """The int8 variant per slot, quantized per ``block_rows`` block (each
    block belongs to one slot)."""
    b, slot, ok = _leaves_rows(comb, block_leaf, num_slots, block_rows,
                               f_limit)
    return _int8_plain(b, ov.prep_f32(grad, hess, mask), block_rows, slot,
                       ok, num_slots, max_bin).float()


def hist_onehot_bench_plain(bins_t, rows, max_bin, variant="base",
                            block_rows=1024):
    """The shootout shell's function: ``bins_t [f, N]`` against the
    variant's prepped ``rows`` (``onehot_variants.VariantSpec.prep``),
    quantized per ``block_rows`` for int8."""
    b = widen_bins(bins_t.t())
    slot, ok = _row_slots(b.shape[0], None, 1, 1, b.device)
    if variant == "int8":
        out = _int8_plain(b, rows, block_rows, slot, ok, 1, max_bin)
    else:
        out = _pair_plain(b, ov.split_bf16_pair(*rows), slot, ok, 1,
                          max_bin)
    return out[0].float()


# --------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# the bin types every kernel takes (its template instantiations)
BIN_TYPES = (torch.uint8, torch.uint16)


# The checks below format their messages only when they fail: a wrapper
# runs them on every call, and the formatting would cost more host time
# than the checks.
def _check_rows(name, mat, grad, hess, mask, dtypes=BIN_TYPES):
    dev = mat.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device")
    if not (mat.dtype in dtypes and mat.dim() == 2 and mat.is_contiguous()):
        kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name}: bins must be a contiguous 2-D {kinds} "
                         "tensor")
    _check_vectors(name, dev, mat.shape[0], grad, hess, mask)


def _check_vectors(name, dev, n, grad, hess, mask):
    for label, t in (("grad", grad), ("hess", hess), ("mask", mask)):
        if not (t.device == dev and t.dtype == torch.float32
                and t.dim() == 1 and t.shape[0] == n and t.is_contiguous()):
            raise ValueError(f"{name}: {label} must be a contiguous float32 "
                             f"[{n}] tensor on {dev}")


# the atomic kernels' launch plan (kernels/hist_common.cuh::plan_launch):
# feature group, tile rows, threads, dynamic shared bytes, CTAs an SM, SMs,
# registers a thread, static shared bytes, spilled bytes a thread, the
# design of the update (0 owned: a warp a feature; 1 dealt: every warp
# but the staging ones takes (step, feature) items, sorted by bin), its
# staging warps (0: every warp stages), the bin tiles of a feature and the
# bins a bin tile holds; it depends on the shape only, so it is kept per
# (kernel, device, stride, f, B, bin size, tiles and design asked) and a
# call splits its rows or blocks with atomic_grid
_PLAN_KEYS = ("fg", "tile", "threads", "dynamic_smem_bytes", "ctas_per_sm",
              "sms", "registers", "static_smem_bytes", "local_bytes",
              "design", "stagers", "tiles", "tile_bins")
_plans: Dict[tuple, Dict[str, int]] = {}
# rows a hist_full CTA takes are a multiple of this (16 rows of any
# stride are whole 16-byte pieces, so every CTA's span starts at the
# matrix's offset in its piece)
_FULL_ROW_ALIGN = 16


def atomic_plan(kernel: str, device: torch.device, stride: int, f: int,
                max_bin: int, esz: int = 1) -> Dict[str, int]:
    """The launch plan of ``hist_full`` or ``hist_leaves`` over ``f``
    features of ``max_bin`` bins in rows of ``stride`` bins of ``esz``
    bytes (1: u8, 2: u16); builds the kernel first if needed.  The plan
    picks the design of the update, unless ``atomic_design`` asks for one,
    and the bin tiles, at least ``atomic_tiles``'s.  A width above
    ``ATOMIC_MAX_BIN`` (no u16 bin reaches it) is refused before any
    kernel is built."""
    _check(0 < max_bin <= ATOMIC_MAX_BIN, f"max_bin={max_bin} is outside "
           f"the atomic kernels' widths (1 to {ATOMIC_MAX_BIN}: every u16 "
           "bin)")
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    want = (-1 if _atomic_design is None
            else ATOMIC_DESIGNS.index(_atomic_design))
    key = (kernel, index, stride, f, max_bin, esz, _atomic_min_tiles, want)
    plan = _plans.get(key)
    if plan is None:
        import ctypes
        buf = (ctypes.c_int * len(_PLAN_KEYS))()
        lib = _build.load(kernel)
        rc = getattr(lib, f"{kernel}_plan")(index, stride, f, max_bin, esz,
                                            want, _atomic_min_tiles, buf)
        _raise_on(lib, f"{kernel} plan", rc)
        plan = _plans[key] = dict(zip(_PLAN_KEYS, buf))
        plan["groups"] = -(-f // plan["fg"])
    return plan


def atomic_grid(plan: Dict[str, int], units: int, align: int = 1):
    """``(CTAs along x, units a CTA)``: ``units`` rows or blocks split over
    the CTAs the card holds at once, each feature group's bin tile a
    column of the grid, the units a CTA rounded up to a multiple of
    ``align``."""
    splits = max(1, max(1, plan["ctas_per_sm"]) * plan["sms"]
                 // (plan["groups"] * plan.get("tiles", 1)))
    per = -(-units // splits)
    per = -(-per // align) * align
    return -(-units // per), per


def atomic_partials(kernel: str, plan: Dict[str, int], units: int,
                    num_slots: int = 1):
    """``(CTAs along x, units a CTA, partials)`` of a call of ``kernel``
    over ``units`` rows (``hist_full``) or blocks (``hist_leaves``): the
    float64 ``[F, B, 3]`` partials its scratch holds, one a CTA along x for
    the full pass and, for the leaves, one for each slot a CTA's blocks may
    name, ``min(blocks a CTA, num_slots)``.  Each CTA writes only its own
    feature group's bin tile of them."""
    full = kernel == "hist_full"
    grid_x, per = atomic_grid(plan, units, _FULL_ROW_ALIGN if full else 1)
    return grid_x, per, grid_x * (1 if full else min(per, num_slots))


# the atomic kernels' constants (kernels/hist_common.cuh): the dealt
# design's ring buffers, the group below which the plan deals, and the
# tile rows, at most and at least
_DEALT_STAGES, _OWNED_MIN_GROUP, _MAX_TILE, _MIN_TILE = 3, 16, 512, 128


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _smem_bytes(fg, B, tile, stride, esz, dealt):
    """``hist_common.cuh::smem_bytes``: the histogram ``[fg][B][3]``
    float64, the lane words (owned) or the tickets and ring barriers
    (dealt), and the staging buffers of ``tile`` rows."""
    if dealt:
        aux = _round16(4 * fg) + 16 * _DEALT_STAGES
    else:
        per_warp = -(-fg // 32)
        aux = _round16(4 * -(-fg // per_warp) * B)
    stride_b, fgb = stride * esz, fg * esz
    pitch = 16 * ((fgb + 30) // 16)
    if stride_b > pitch:
        bins = tile * pitch
    else:
        bins = _round16((tile - 1) * stride_b + fgb) + 32
    vals = _round16(4 * tile) + 32
    return (_round16(24 * fg * B) + aux
            + (_DEALT_STAGES if dealt else 2) * (bins + 3 * vals))


def _fit_tile(g, B, stride, esz, dealt, min_tile):
    """``hist_common.cuh::fit_tile``: the most tile rows that fit."""
    t = _MAX_TILE
    while t >= min_tile:
        if _smem_bytes(g, B, t, stride, esz, dealt) <= SMEM_MAX_BYTES:
            return t
        t -= 32 if t > 32 else 1
    return 0


def _plan_geometry(f, B, stride, esz, dealt, min_tiles):
    """``hist_common.cuh::plan_geometry``: ``(fg, tile rows, tiles, tile
    bins)`` or None."""
    for t in range(max(1, min_tiles), B + 1):
        bt = -(-B // t)
        for g in range(f, 0, -1):
            tile = _fit_tile(g, bt, stride, esz, dealt, _MIN_TILE)
            if tile:
                return g, tile, -(-B // bt), bt
    return None


def atomic_geometry(f: int, max_bin: int, stride: int, esz: int = 1,
                    design: Optional[str] = None,
                    min_tiles: int = 1) -> Dict[str, int]:
    """The atomic kernels' plan geometry without a card: the C plan's
    arithmetic (``kernels/hist_common.cuh::plan_launch``) up to the
    occupancy it asks the card for -- the design, the feature group and
    tile rows, the bin tiles of a feature and the bins each holds, and the
    dynamic shared bytes.  The plan itself may then narrow an untiled
    group to fill the card's last wave; a tiled plan holds one feature a
    CTA and keeps it.  Card tests hold it against ``atomic_plan``."""
    if design is None:
        owned = _plan_geometry(f, max_bin, stride, esz, False, min_tiles)
        pick = (owned is not None and owned[2] == 1
                and owned[0] >= min(f, _OWNED_MIN_GROUP))
        design = ATOMIC_DESIGNS[0 if pick else 1]
    dealt = design == "dealt"
    geo = _plan_geometry(f, max_bin, stride, esz, dealt, min_tiles)
    _check(geo is not None, f"no plan for {f} features of {max_bin} bins")
    fg, tile, tiles, bt = geo
    if dealt:
        groups = -(-f // fg)
        g = -(-f // groups)
        if g < fg:
            fg, tile = g, _fit_tile(g, bt, stride, esz, True, _MIN_TILE)
    return {"design": ATOMIC_DESIGNS.index(design), "fg": fg, "tile": tile,
            "tiles": tiles, "tile_bins": bt, "groups": -(-f // fg),
            "dynamic_smem_bytes": _smem_bytes(fg, bt, tile, stride, esz,
                                              dealt)}


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.lgbt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def hist_full(bins, grad, hess, mask, max_bin, f_limit=None):
    """``[F, B, 3]`` histogram by the ``hist_full`` CUDA kernel: one launch
    of the kernel over the plan's CTAs, each writing a float64 partial
    into scratch, and one of the reduce kernel, which sums them into the
    float32 result.  ``bins`` is ``uint8`` or ``uint16``."""
    _check_rows("hist_full", bins, grad, hess, mask)
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    dev = bins.device
    esz = bins.element_size()
    if n == 0 or f == 0:
        return torch.zeros(f, max_bin, 3, device=dev)
    plan = atomic_plan("hist_full", dev, ncols, f, max_bin, esz)
    grid_x, per_cta, _ = atomic_partials("hist_full", plan, n)
    partial = torch.empty(grid_x, f, max_bin, 3, dtype=torch.float64,
                          device=dev)
    out = torch.empty(f, max_bin, 3, device=dev)
    lib = _build.load("hist_full")
    rc = lib.hist_full_launch(
        dev.index, bins.data_ptr(), n, ncols, f, max_bin, esz,
        grad.data_ptr(),
        hess.data_ptr(), mask.data_ptr(), partial.data_ptr(), out.data_ptr(),
        plan["fg"], plan["tile"], plan["tiles"], plan["tile_bins"],
        plan["threads"], plan["design"], grid_x, per_cta,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, "hist_full", rc)
    launch_counts["hist_full"] += 1
    return out


def hist_leaves(comb, grad, hess, mask, block_leaf, num_slots, max_bin,
                block_rows=512, f_limit=None):
    """``[num_slots, F, B, 3]`` histograms by the ``hist_leaves`` CUDA
    kernel: one launch over the plan's CTAs, each writing one float64
    partial per slot its blocks name into scratch and naming the slot
    there, and one of the reduce kernel, which sums each slot's partials
    into the float32 result.  ``comb`` is ``uint8`` or ``uint16``."""
    _check_rows("hist_leaves", comb, grad, hess, mask)
    c, nc = comb.shape
    f = _n_feat(nc, f_limit)
    dev = comb.device
    esz = comb.element_size()
    if not (block_rows > 0 and c % block_rows == 0):
        raise ValueError(f"hist_leaves: rows ({c}) must be a multiple of "
                         f"block_rows ({block_rows})")
    nb = c // block_rows
    if not (block_leaf.device == dev and block_leaf.dtype == torch.int32
            and block_leaf.dim() == 1 and block_leaf.shape[0] == nb
            and block_leaf.is_contiguous()):
        raise ValueError(f"hist_leaves: block_leaf must be a contiguous "
                         f"int32 [{nb}] tensor on {dev}")
    if nb == 0 or f == 0 or num_slots == 0:
        return torch.zeros(num_slots, f, max_bin, 3, device=dev)
    plan = atomic_plan("hist_leaves", dev, nc, f, max_bin, esz)
    # the partials (float64 [grid x * parts, F, B, 3]: a CTA writes one for
    # each slot its blocks name), then their slots
    grid_x, bpc, n_partial = atomic_partials("hist_leaves", plan, nb,
                                             num_slots)
    parts = n_partial // grid_x
    scratch = torch.empty(n_partial * (f * max_bin * 3 * 8 + 4),
                          dtype=torch.uint8, device=dev)
    out = torch.empty(num_slots, f, max_bin, 3, device=dev)
    lib = _build.load("hist_leaves")
    rc = lib.hist_leaves_launch(
        dev.index, comb.data_ptr(), c, nc, f, max_bin, esz, grad.data_ptr(),
        hess.data_ptr(), mask.data_ptr(), block_leaf.data_ptr(), block_rows,
        num_slots, scratch.data_ptr(), out.data_ptr(), plan["fg"],
        plan["tile"], plan["tiles"], plan["tile_bins"], plan["threads"],
        plan["design"], grid_x, bpc, parts,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, "hist_leaves", rc)
    launch_counts["hist_leaves"] += 1
    return out


# --------------------------------------------------------------------------
# one-hot kernel wrappers (CUDA tensors only)
# --------------------------------------------------------------------------

# the kernels' geometry (kernels/onehot_common.cuh): 128-thread CTAs of 512
# output lanes that stage 128 rows at a time; the launchers size the grid
# to the CTAs the card holds at once
_OH_BLOCK_LANES = 512
_OH_CHUNK = 128
# the widest bin range the one-hot kernels take: any u16 bin (the bodies
# that serve it: VariantSpec.supports)
ONEHOT_MAX_BIN = 65536


def _onehot_spec(variant: str, max_bin: int, layout: str) -> ov.VariantSpec:
    """The variant's spec, after the checks every one-hot entry point makes
    (the JAX kernels' own: an unknown layout, or a variant that cannot
    serve the width, is an error; ``resolve`` picks a variant first)."""
    _check(layout in LAYOUTS, f"unknown histogram layout {layout!r}")
    _check(variant in ov.VARIANTS, f"unknown hist_variant {variant!r}; "
           f"known: {', '.join(ov.VARIANT_NAMES)}")
    spec = ov.VARIANTS[variant]
    _check(0 < max_bin <= ONEHOT_MAX_BIN and spec.supports(max_bin),
           f"hist variant {variant!r} does not support max_bin={max_bin} "
           "(resolve the variant with onehot_variants.resolve first)")
    return spec


# the bucketed kernels' geometry (kernels/onehot_bucket.cuh): CTAs of 8
# warps, each CTA owning up to 8 buckets of 128 lanes of one feature, and
# their dynamic shared bytes per body family (a constant: a segment's
# compacted rows, a region a bucket, the helper runs' slots, the counts
# and places, and int8's float64 sums)
_OH_BUCKET_THREADS = 256
_OH_BUCKETS_PER_CTA = 8
_OH_BUCKET_SMEM = {"bf16": 110560, "int8": 111680}
_OH_GRID_Y_MAX = 65535
# the bucketed kernels sort a segment of up to 512 rows at a time, and an
# int8 segment never spans two quantization blocks: blocks of fewer rows
# leave each sort too little work (a block of 128 rows made the bucketed
# int8 kernel slower than the dense one on the card), so int8 keeps the
# dense design there
_OH_BUCKET_INT8_MIN_BLOCK = 512


def onehot_plan(variant: str, f: int, max_bin: int,
                block_rows: Optional[int] = None) -> Dict[str, int]:
    """The one-hot kernels' plan for ``f`` features of ``max_bin`` bins
    (``int8``: quantized per ``block_rows`` rows): its design
    (``ONEHOT_DESIGNS``), threads a CTA, dynamic shared bytes, and for the
    bucketed design the buckets of a feature, the CTAs a feature takes
    (``gpf``) and the buckets each owns (``bpg``).  Every u8 width
    (``max_bin`` <= 256) takes the dense design of PRs 5-6; every u16 width
    the bucketed one, but for int8 over blocks of fewer than 512 rows, and
    unless ``onehot_design`` asks for the dense one.  A design the width
    does not serve (bucketed at u8) is refused.  Computed from the kernels'
    constants alone (no card): the card tests hold it against the kernels'
    own query."""
    allowed = ONEHOT_DESIGNS if max_bin > 256 else ONEHOT_DESIGNS[:1]
    small_blocks = (variant == "int8" and block_rows is not None
                    and block_rows < _OH_BUCKET_INT8_MIN_BLOCK)
    design = ((allowed[0] if small_blocks else allowed[-1])
              if _onehot_design is None else _onehot_design)
    _check(design in allowed, f"the {design} one-hot design does not "
           f"serve max_bin={max_bin} (u8 bins take the dense design)")
    if design == "dense":
        return {"design": "dense", "threads": 128}
    nb = ov.padded_bins(max_bin) // 128
    gpf = -(-nb // _OH_BUCKETS_PER_CTA)
    _check(f * gpf <= _OH_GRID_Y_MAX, f"{f} features of {max_bin} bins "
           f"need {f * gpf} CTAs along y, above {_OH_GRID_Y_MAX}")
    return {"design": "bucketed", "threads": _OH_BUCKET_THREADS,
            "dynamic_smem_bytes": _OH_BUCKET_SMEM[
                "int8" if variant == "int8" else "bf16"],
            "buckets": nb, "gpf": gpf, "bpg": -(-nb // gpf)}


def _onehot_out(plan, lead, lanes, device):
    """The zeroed float64 accumulator a one-hot kernel adds into: ``[...,
    6, lanes]`` (hi and lo rows), or ``[..., 3, lanes]`` for the bucketed
    design, which adds hi and lo itself."""
    rows = 3 if plan["design"] == "bucketed" else 6
    return torch.zeros(*lead, rows, lanes, dtype=torch.float64,
                       device=device)


def _onehot_geometry(spec, f, max_bin):
    """(Bp, lanes, lanes per feature ``lpf``, most features one CTA's 512
    lanes read).  The kernels map lane ``l`` to feature ``l // lpf`` and
    bin ``l % lpf``; ``lpf`` is a multiple of 128 (Bp) or, packed, a power
    of two that divides 128."""
    Bp = ov.padded_bins(max_bin)
    lanes = ov.feat_geometry(spec, f, max_bin, Bp)[1]
    lpf = ov.lanes_per_feature(spec, max_bin)
    return Bp, lanes, lpf, _cta_features_max(f, lpf, lanes)


@functools.lru_cache(maxsize=None)
def _cta_features_max(f, lpf, lanes):
    """The most features a CTA's lanes ``[l, l + 512)`` touch, over the
    CTAs of ``lanes`` (kernels/onehot_common.cuh::cta_features): it sizes
    their shared bin buffers.  At least 1: from Bp = 1,024 on, one CTA's
    lanes hold part of one feature."""
    return max(1, max(min(f, (lb + _OH_BLOCK_LANES - 1) // lpf + 1) - lb // lpf
                      for lb in range(0, lanes, _OH_BLOCK_LANES)))


# most rows one quantization block may hold: the quantize kernel keeps a
# block's rows in the registers of at most 1024 threads (16 rows each)
_QUANT_MAX_ROWS = 16384


def _quantize(x0, x1, x2, prep, block_rows):
    """The ``onehot_quant`` kernel on three ``[N]`` float32 vectors on one
    CUDA device: ``grad, hess, mask`` (``prep``: it forms ``g·m`` and
    ``h·m``) or the three rows of prepped ``[3, N]`` rows.  ``q`` is a view
    of a ``[9, ldq]`` buffer, ``ldq`` = ``N`` rounded up to 128, whose
    columns past ``N`` the kernel sets to zero: the int8 one-hot kernels
    read it in whole 128-row chunks."""
    dev = x0.device
    _check(block_rows % _OH_CHUNK == 0 and 0 < block_rows <= _QUANT_MAX_ROWS,
           f"onehot_quant: block_rows ({block_rows}) must be a multiple of "
           f"{_OH_CHUNK} and at most {_QUANT_MAX_ROWS}")
    n = x0.shape[0]
    nb = -(-n // block_rows)
    ldq = -(-n // _OH_CHUNK) * _OH_CHUNK
    q = torch.empty(9, ldq, dtype=torch.int8, device=dev)
    s = torch.empty(nb, 9, dtype=torch.float32, device=dev)
    if n > 0:
        lib = _build.load("onehot_quant")
        rc = lib.onehot_quant_launch(
            dev.index, x0.data_ptr(), x1.data_ptr(), x2.data_ptr(), int(prep),
            n, block_rows, q.data_ptr(), s.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, "onehot_quant", rc)
        launch_counts["onehot_quant"] += 1
    return q[:, :n], s


def quantize_int8(grad, hess, mask, block_rows):
    """The int8 variant's pre-pass: ``(q [9, N] int8, s [nblocks, 9]
    float32)``, the rows ``(g·m, h·m, m)`` quantized in three levels per
    block of ``block_rows`` rows, bit-identical to
    ``quantize_int8_blocks_plain(prep_f32(grad, hess, mask), block_rows)``,
    which CPU tensors take.  On CUDA tensors (``force_plain`` or not: the
    int8 kernels read ``q`` as this route lays it out) one launch of the
    ``onehot_quant`` kernel, which reads ``grad``, ``hess`` and ``mask``
    and forms the products itself; ``q`` is then a view of a ``[9, ldq]``
    buffer padded with zeros (``_quantize``)."""
    dev, n = grad.device, grad.shape[0]
    if dev.type == "cpu":
        return ov.quantize_int8_blocks_plain(ov.prep_f32(grad, hess, mask),
                                             block_rows)
    _check(dev.type == "cuda", "onehot_quant: tensors must be on a CUDA "
           "device")
    _check_vectors("onehot_quant", dev, n, grad, hess, mask)
    return _quantize(grad, hess, mask, True, block_rows)


def quantize_int8_blocks(rows, block_rows):
    """``(q [9, N] int8, s [nblocks, 9] float32)`` of prepped ``rows [3,
    N]`` float32 (``prep_f32``'s, as the shootout shell is handed them) by
    the ``onehot_quant`` kernel, which reads them as given; CUDA tensors
    only.  Bit-identical to ``onehot_variants.quantize_int8_blocks_plain``;
    ``q`` as ``quantize_int8`` gives it."""
    _check(rows.device.type == "cuda", "onehot_quant: tensors must be on a "
           "CUDA device")
    _check(rows.dtype == torch.float32 and rows.dim() == 2
           and rows.shape[0] == 3 and rows.is_contiguous(),
           "onehot_quant: rows must be a contiguous float32 [3, N] tensor")
    return _quantize(rows[0], rows[1], rows[2], False, block_rows)


def _operands(spec, grad, hess, mask, qbr):
    """What the kernel reads besides the bins, as ``(g, h, m, q, scales)``:
    the bf16-pair kernels split ``grad``, ``hess`` and ``mask`` into the
    pair themselves (16-byte aligned: a misaligned view is copied), int8
    reads the quantize kernel's ``q [9, N]`` (rows padded to a multiple of
    128 with zeros) and its scales per ``qbr`` rows, which that kernel
    makes from ``grad``, ``hess`` and ``mask`` in one launch."""
    if spec.name == "int8":
        return (None, None, None, *quantize_int8(grad, hess, mask, qbr))
    rows = [t if t.data_ptr() % 16 == 0 else t.clone()
            for t in (grad, hess, mask)]
    return (*rows, None, None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def hist_onehot_full(bins, grad, hess, mask, max_bin, f_limit=None,
                     variant="base", layout="featmajor"):
    """``[F, B, 3]`` histogram by the ``onehot_full`` CUDA kernel: the
    variant's one-hot body, reading a ``[F, N]`` transposed copy of the bins
    (``featmajor``, as the Pallas path does) or the ``[N, NC]`` matrix as
    stored (``rowmajor``).  The bucketed design (u16, ``onehot_plan``)
    gathers each CTA's feature from the rows itself, so it reads the
    matrix as stored in both layouts and no copy is made.  ``int8`` first
    runs the quantize kernel over the JAX package's row blocks for the
    layout asked for.  ``bins`` is ``uint8`` or ``uint16``."""
    _check_rows("onehot_full", bins, grad, hess, mask)
    spec = _onehot_spec(variant, max_bin, layout)
    n, ncols = bins.shape
    f = _n_feat(ncols, f_limit)
    Bp, lanes, lpf, nf_max = _onehot_geometry(spec, f, max_bin)
    qbr = ov.pallas_block_rows(variant, layout, n, f, max_bin)
    plan = onehot_plan(variant, f, max_bin, qbr)
    out = _onehot_out(plan, (), lanes, bins.device)
    if n > 0 and f > 0:
        ops = _operands(spec, grad, hess, mask, qbr)
        if layout == "featmajor" and plan["design"] == "dense":
            # the kernel copies whole 128-row chunks of each feature, so
            # the copy's rows reach the last chunk's end (the rows past n
            # have zero weight and are never summed); u16 moves as int16
            ld = -(-n // _OH_CHUNK) * _OH_CHUNK
            mv = movable_bins(bins)
            src = mv.new_empty(f, ld)
            src[:, :n] = mv[:, :f].t()
            lay = 0
        else:
            src, ld, lay = bins, ncols, 1
        lib = _build.load("onehot_full")
        rc = lib.onehot_full_launch(
            bins.device.index, src.data_ptr(), ld, n, f, lay,
            bins.element_size(), *map(_ptr, ops), qbr, out.data_ptr(),
            spec.kernel_id, lpf, lanes, nf_max,
            ONEHOT_DESIGNS.index(plan["design"]),
            torch.cuda.current_stream(bins.device).cuda_stream)
        _raise_on(lib, "onehot_full", rc)
        launch_counts["onehot_full"] += 1
    return ov.finish_hist(out, f, max_bin, Bp, spec).float()


def hist_onehot_leaves(comb, grad, hess, mask, block_leaf, num_slots,
                       max_bin, block_rows=512, f_limit=None,
                       variant="base"):
    """``[num_slots, F, B, 3]`` histograms by the ``onehot_leaves`` CUDA
    kernel, reading ``comb [C, NC]`` (``uint8`` or ``uint16``) as the
    frontier gathers it; ``int8`` quantizes per ``block_rows`` block (one
    slot's rows).  Any width: the cut (``onehot_leaves_fits``) is
    ``build_histogram_leaves``'s."""
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
    Bp, lanes, lpf, nf_max = _onehot_geometry(spec, f, max_bin)
    plan = onehot_plan(variant, f, max_bin, block_rows)
    out = _onehot_out(plan, (num_slots,), lanes, comb.device)
    if nb > 0 and f > 0 and num_slots > 0:
        ops = _operands(spec, grad, hess, mask, block_rows)
        lib = _build.load("onehot_leaves")
        rc = lib.onehot_leaves_launch(
            comb.device.index, comb.data_ptr(), nc, c, f,
            comb.element_size(), *map(_ptr, ops), block_leaf.data_ptr(),
            block_rows, num_slots, out.data_ptr(), spec.kernel_id, lpf,
            lanes, nf_max, ONEHOT_DESIGNS.index(plan["design"]),
            torch.cuda.current_stream(comb.device).cuda_stream)
        _raise_on(lib, "onehot_leaves", rc)
        launch_counts["onehot_leaves"] += 1
    return ov.finish_hist(out, f, max_bin, Bp, spec).float()


def hist_onehot_bench(bins_t, rows, max_bin, variant="base",
                      block_rows=1024):
    """The shootout shell (``make_bench_kernel``'s ``run``): ``[f, B, 3]``
    histograms of ``bins_t [f, N]`` u8 or u16, transposed by the caller
    and read as given, against the variant's prepped ``[3, N]`` float32
    ``rows`` (``VariantSpec.prep``); ``N`` a multiple of ``block_rows``,
    the quantization block of int8.  The ``onehot_bench`` entry of the
    ``onehot_full`` kernel, which launches the main path's featmajor
    kernel, on CUDA tensors (after the quantize kernel, for int8); the
    plain version on CPU tensors."""
    spec = _onehot_spec(variant, max_bin, "featmajor")
    _check(bins_t.dim() == 2 and rows.dim() == 2
           and rows.shape[1] == bins_t.shape[1],
           "onehot_bench: bins_t must be [f, N] and rows [R, N]")
    f, n = bins_t.shape
    _check(block_rows > 0 and block_rows % _OH_CHUNK == 0
           and n % block_rows == 0,
           f"onehot_bench: rows ({n}) must be a multiple of block_rows "
           f"({block_rows}), itself a multiple of {_OH_CHUNK}")
    _check(rows.shape[0] == 3 and rows.dtype == torch.float32,
           "onehot_bench: rows must be [3, N] float32 (the variant's prep)")
    if _plain(bins_t):
        return hist_onehot_bench_plain(bins_t, rows, max_bin, variant,
                                       block_rows)
    dev = bins_t.device
    _check(dev.type == "cuda" and rows.device == dev,
           "onehot_bench: tensors must be on one CUDA device")
    _check(bins_t.dtype in BIN_TYPES and bins_t.is_contiguous()
           and rows.is_contiguous(),
           "onehot_bench: bins_t must be contiguous uint8 or uint16, rows "
           "contiguous")
    Bp, lanes, lpf, nf_max = _onehot_geometry(spec, f, max_bin)
    plan = onehot_plan(variant, f, max_bin, block_rows)
    out = _onehot_out(plan, (), lanes, dev)
    if n > 0 and f > 0:
        # the kernel's 16-byte copies need 16-byte aligned rows (u16 moves
        # as int16)
        if bins_t.data_ptr() % 16:
            bins_t = movable_bins(bins_t).clone().view(bins_t.dtype)
        if rows.data_ptr() % 16:
            rows = rows.clone()
        if variant == "int8":
            rows, scales = quantize_int8_blocks(rows, block_rows)
        else:
            scales = None
        lib = _build.load("onehot_full")
        rc = lib.onehot_bench_launch(
            dev.index, bins_t.data_ptr(), n, f, bins_t.element_size(),
            rows.data_ptr(), _ptr(scales), block_rows, out.data_ptr(),
            spec.kernel_id, lpf, lanes, nf_max,
            ONEHOT_DESIGNS.index(plan["design"]),
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, "onehot_bench", rc)
        launch_counts["onehot_bench"] += 1
    return ov.finish_hist(out, f, max_bin, Bp, spec).float()


def onehot_kernel_attributes(kernel: str, variant: str, f: int, max_bin: int,
                             layout: str = "rowmajor",
                             ld: Optional[int] = None,
                             block_rows: Optional[int] = None
                             ) -> Dict[str, int]:
    """The design (``onehot_plan``'s, or ``onehot_design``'s) and
    registers a thread, static shared bytes and spilled bytes a thread
    of the ``onehot_full`` (per ``layout``) or ``onehot_leaves`` kernel of
    ``variant`` in that design over the bins a matrix of ``max_bin`` bins
    holds (u8 up to 256, u16 above), from ``cudaFuncGetAttributes``, and
    the dynamic shared bytes of its launch over ``f`` features at
    ``max_bin`` (row-major rows of ``ld`` bins, ``f`` by default, 16-byte
    aligned) and the CTAs an SM then holds (the occupancy calculator's
    count, which sizes the grid); builds the kernel first if needed.
    ``block_rows``: int8's quantization block, by default the main path's
    (the full pass's ``pallas_block_rows`` at a large ``N``, or the
    frontier's 512 rows a leaves block), which the plan reads."""
    import ctypes
    spec = _onehot_spec(variant, max_bin, layout)
    nf_max = _onehot_geometry(spec, f, max_bin)[3]
    if block_rows is None:
        block_rows = (ov.pallas_block_rows(variant, layout, 1 << 20, f,
                                           max_bin)
                      if kernel == "onehot_full" else 512)
    design = onehot_plan(variant, f, max_bin, block_rows)["design"]
    ld = f if ld is None else ld
    esz = 1 if max_bin <= 256 else 2
    buf = (ctypes.c_int * 5)()
    lib = _build.load(kernel)
    if kernel == "onehot_full":
        rc = lib.onehot_full_query(spec.kernel_id, LAYOUTS.index(layout),
                                   nf_max, ld, esz,
                                   ONEHOT_DESIGNS.index(design), buf)
    else:
        _check(kernel == "onehot_leaves" and layout == "rowmajor",
               f"no attribute query for {kernel} ({layout})")
        rc = lib.onehot_leaves_query(spec.kernel_id, nf_max, ld, esz,
                                     ONEHOT_DESIGNS.index(design), buf)
    _raise_on(lib, f"{kernel} query", rc)
    return dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                     "local_bytes", "ctas_per_sm"), buf), design=design)


def quant_kernel_attributes(block_rows: int) -> Dict[str, int]:
    """Registers a thread and spilled bytes a thread of the quantize kernel
    that serves ``block_rows``-row blocks, from ``cudaFuncGetAttributes``,
    and its geometry: rows a thread, threads a block, blocks a CTA; builds
    the kernel first if needed."""
    import ctypes
    buf = (ctypes.c_int * 5)()
    lib = _build.load("onehot_quant")
    _raise_on(lib, "onehot_quant query",
              lib.onehot_quant_query(block_rows, buf))
    return dict(zip(("registers", "local_bytes", "rows_per_thread",
                     "threads_per_block", "blocks_per_cta"), buf))
