"""One-hot histogram variants: the registry, its lane geometry, the prep.

Port of the JAX package's ``ops/onehot_variants.py`` for the row-wise
(``force_row_wise``) histogram path.  The histogram is ``gh · onehotᵀ``:
the six bf16 rows of ``split_bf16_pair`` (the (hi, lo) halves of
``g·m, h·m, m``) times an exact 0/1 one-hot of each row's bin over the
output lanes.  Every bf16-pair variant computes that same function and
differs only in how the one-hot is built (its compare domain) and, for
``packed``, in the lane map; on the card each is one body of the
tensor-core kernels (``kernels/onehot_common.cuh``), selected by
``VariantSpec.kernel_id``.

Kept from the JAX module, as copies (its package ``__init__`` imports
jax): ``padded_bins``, ``pack_k``, ``VariantSpec`` (geometry and
``supports``), ``VARIANTS``/``VARIANT_NAMES``, ``AUTO_CANDIDATES``,
``feat_geometry``, ``total_lanes``, ``resolve`` and ``finish_hist`` (the
one inverse lane map, in torch).  Not carried over: the TPU VPU work model
(``vpu_compares``, ``predicted_mfu``, ``VPU_MXU_RATIO``), which prices the
TPU's vector unit against its MXU and says nothing about a Hopper card;
the Pallas bodies, whose counterparts are the CUDA builders; and the
first-fit election (``pick_variant``) with its shootout shell and the
``int8`` body, which are not ported yet: ``resolve('int8')`` raises
``NotPortedError``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..device import NotPortedError
from ..utils.log import Log


def padded_bins(max_bin: int) -> int:
    """Lane-group-aligned bin width Bp (128-multiple)."""
    return -(-max_bin // 128) * 128


def pack_k(max_bin: int) -> int:
    """Features per 128-lane group for the lane-packing variant, or 0 when
    packing does not apply: the width must divide 128 and be at most 64
    (2/4/8/16/32/64), so that ``k = 128 // B`` slots of exactly ``B`` lanes
    tile a group."""
    if max_bin <= 0 or max_bin > 64 or 128 % max_bin:
        return 0
    return 128 // max_bin


class VariantSpec(NamedTuple):
    """One one-hot build strategy.

    group_lanes/group_feats: output-lane geometry; ``group_feats`` features
        share one ``group_lanes``-wide lane group (1 per ``Bp`` lanes for the
        unpacked variants, ``k`` per 128 lanes for lane packing).
    supports(B): static eligibility for a kernel bin width.
    kernel_id: the body's number in ``kernels/onehot_common.cuh``, or None
        when the body is not ported.
    """
    name: str
    description: str
    group_lanes: Callable      # (B, Bp) -> int
    group_feats: Callable      # (B, Bp) -> int
    supports: Callable         # (B) -> bool
    kernel_id: Optional[int]


def _geom_plain(B, Bp):
    return Bp


def _one(B, Bp):
    return 1


VARIANTS = {
    "base": VariantSpec(
        "base", "int32 compare -> bf16 one-hot",
        _geom_plain, _one, lambda B: True, 0),
    "bf16cmp": VariantSpec(
        "bf16cmp", "bf16 bins == bf16 lane id",
        _geom_plain, _one, lambda B: B <= 256, 1),
    "i16cmp": VariantSpec(
        "i16cmp", "int16 compare",
        _geom_plain, _one, lambda B: B <= 32768, 2),
    "u8cmp": VariantSpec(
        "u8cmp", "uint8 compare",
        _geom_plain, _one, lambda B: B <= 256, 3),
    "sub1abs": VariantSpec(
        "sub1abs", "onehot = max(0, 1 - |b - j|) in bf16 (no compare)",
        _geom_plain, _one, lambda B: B <= 256, 4),
    "staged": VariantSpec(
        "staged", "hi-digit one-hot * lo-digit one-hot (digit width 16)",
        _geom_plain, _one, lambda B: True, 5),
    "packed": VariantSpec(
        "packed", "k=128//B features per 128-lane group (B <= 64, B | 128)",
        lambda B, Bp: 128, lambda B, Bp: 128 // B,
        lambda B: pack_k(B) >= 2, 6),
    "int8": VariantSpec(
        "int8", "int8 one-hot, per-block quantized gh (not ported)",
        _geom_plain, _one, lambda B: True, None),
}

VARIANT_NAMES = tuple(VARIANTS)

# the JAX election's candidates (its first-fit micro-bench is not ported)
AUTO_CANDIDATES = ("base", "u8cmp", "staged", "packed", "int8")


def feat_geometry(spec: VariantSpec, f: int, B: int, Bp: int):
    """(f_pad, lanes): the feature count padded to a lane-group multiple and
    the output lane count.  The forward lane map is
    ``lane = feature * (group_lanes // group_feats) + bin``; ``finish_hist``
    is its inverse."""
    gf = spec.group_feats(B, Bp)
    f_pad = -(-f // gf) * gf
    return f_pad, (f_pad // gf) * spec.group_lanes(B, Bp)


def total_lanes(name: str, f: int, max_bin: int) -> int:
    """Output lane count a variant needs for ``f`` features."""
    return feat_geometry(VARIANTS[name], f, max_bin, padded_bins(max_bin))[1]


def lanes_per_feature(spec: VariantSpec, B: int) -> int:
    """Output lanes of one feature: ``Bp``, or ``B`` under lane packing.
    Always a power of two here (Bp is 128 or 256; a packed B divides 128)."""
    Bp = padded_bins(B)
    return spec.group_lanes(B, Bp) // spec.group_feats(B, Bp)


def resolve(name: str, max_bin: int) -> str:
    """Validate ``name`` against the registry and the kernel bin width;
    returns a supported variant name (falling back to 'base' with a warning
    when the requested family cannot serve this width, as the JAX package
    does).  ``int8`` is in the registry but not ported: it raises."""
    if name not in VARIANTS:
        raise ValueError(f"unknown hist_variant {name!r}; "
                         f"known: {', '.join(VARIANT_NAMES)}")
    if VARIANTS[name].kernel_id is None:
        raise NotPortedError(f"hist_variant={name} is not ported yet "
                             "(its kernel body comes with the variant "
                             "election)")
    if not VARIANTS[name].supports(max_bin):
        Log.warning("hist_variant=%s does not support max_bin=%d; "
                    "using 'base'", name, max_bin)
        return "base"
    return name


def finish_hist(out: torch.Tensor, f: int, B: int, Bp: int,
                spec: VariantSpec) -> torch.Tensor:
    """``[..., 6, lanes]`` kernel output -> ``[..., f, B, 3]`` histograms:
    sum the (hi, lo) triples and undo the lane layout (plain ``Bp``-wide
    slots, or the packed ``group*128 + f_local*B + bin`` layout).  Keeps
    the input's dtype."""
    gl = spec.group_lanes(B, Bp)
    gf = spec.group_feats(B, Bp)
    lead = tuple(out.shape[:-2])
    ng = out.shape[-1] // gl
    o = out.reshape(lead + (2, 3, ng, gl))
    hist = o[..., 0, :, :, :] + o[..., 1, :, :, :]       # [..., 3, ng, gl]
    hist = hist[..., :gf * B].reshape(lead + (3, ng * gf, B))
    hist = hist[..., :f, :]
    return torch.movedim(hist, -3, -1)                   # [..., f, B, 3]


def split_bf16_pair(grad: torch.Tensor, hess: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """``[6, N]`` bf16: the float32 channel rows ``(g·m, h·m, m)`` split
    into ``hi = bf16(x)`` and ``lo = bf16(x - f32(hi))``, hi rows first, so
    the pair carries ~16 mantissa bits (the JAX package's ``_gh6``).  Eager
    PyTorch has no excess-precision rewrite of ``f32(bf16(x))`` to fence
    against, so ``lo`` needs no barrier here."""
    gh = torch.stack([grad * mask, hess * mask, mask]).float()
    hi = gh.to(torch.bfloat16)
    lo = (gh - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo]).contiguous()
