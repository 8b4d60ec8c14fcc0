"""One-hot histogram variants: the registry, its lane geometry, the prep,
the int8 quantizer, the single-block shootout shell and the election.

Port of the JAX package's ``ops/onehot_variants.py`` for the row-wise
(``force_row_wise``) histogram path.  The histogram is ``rows · onehotᵀ``:
an exact 0/1 one-hot of each row's bin over the output lanes times the
variant's rows.  The seven bf16-pair variants multiply the six bf16 rows of
``split_bf16_pair`` (the (hi, lo) halves of ``g·m, h·m, m``) and differ
only in how the one-hot is built (its compare domain) and, for ``packed``,
in the lane map.  ``int8`` multiplies an int8 one-hot by the nine int8 rows
that ``quantize_int8_blocks_plain`` makes of ``prep_f32``'s three float32
rows, per block of rows, with int32 sums folded by the block's scales.  On
the card each variant is one body of the tensor-core kernels
(``kernels/onehot_common.cuh``), selected by ``VariantSpec.kernel_id``.

Kept from the JAX module, as copies (its package ``__init__`` imports
jax): ``padded_bins``, ``pack_k``, ``VariantSpec`` (prep, geometry and
``supports``), ``VARIANTS``/``VARIANT_NAMES``, ``AUTO_CANDIDATES``,
``feat_geometry``, ``total_lanes``, ``resolve``, ``finish_hist`` (the one
inverse lane map, in torch), the int8 ``level`` chain
(``quantize_int8_blocks_plain``), the shootout shell ``make_bench_kernel``
and the election (``pick_variant``, ``_run_auto_bench``,
``_time_auto_candidate``, ``_auto_bench_data``, ``_AUTO_CACHE``).  Not
carried over: the TPU VPU work model (``vpu_compares``, ``predicted_mfu``,
``VPU_MXU_RATIO``), which prices the TPU's vector unit against its MXU and
says nothing about a Hopper card; and the Pallas bodies, whose counterparts
are the CUDA builders.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

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
    prep(grad, hess, mask) -> the ``[3, N]`` float32 rows the shootout
        shell's kernel reads: ``grad, hess, mask`` as given
        (``stack_rows``; the bf16-pair kernels split them into the pair
        themselves) or, for int8, ``(g·m, h·m, m)`` (``prep_f32``),
        quantized per block of rows by the kernel's shell.
    supports(B): static eligibility for a kernel bin width.
    kernel_id: the body's number in ``kernels/onehot_common.cuh``.
    """
    name: str
    description: str
    prep: Callable
    group_lanes: Callable      # (B, Bp) -> int
    group_feats: Callable      # (B, Bp) -> int
    supports: Callable         # (B) -> bool
    kernel_id: int


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


def stack_rows(grad: torch.Tensor, hess: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``[3, N]`` float32 rows ``grad, hess, mask`` as given: what the
    bf16-pair kernels read, splitting ``(g·m, h·m, m)`` into the bf16 pair
    (``split_bf16_pair``) as each chunk lands in shared memory."""
    return torch.stack([grad, hess, mask]).float().contiguous()


def prep_f32(grad: torch.Tensor, hess: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """``[3, N]`` float32 channel rows ``(g·m, h·m, m)``: the int8
    variant's rows, which its plain versions quantize per block of rows and
    the shootout shell hands the quantize kernel.  The int8 histogram
    wrappers do not make them on the card: their quantize kernel forms the
    products from grad, hess and mask itself (``histogram.quantize_int8``)."""
    return torch.stack([grad * mask, hess * mask, mask]).float().contiguous()


def _geom_plain(B, Bp):
    return Bp


def _one(B, Bp):
    return 1


VARIANTS = {
    "base": VariantSpec(
        "base", "int32 compare -> bf16 one-hot", stack_rows,
        _geom_plain, _one, lambda B: True, 0),
    "bf16cmp": VariantSpec(
        "bf16cmp", "bf16 bins == bf16 lane id", stack_rows,
        _geom_plain, _one, lambda B: B <= 256, 1),
    "i16cmp": VariantSpec(
        "i16cmp", "int16 compare", stack_rows,
        _geom_plain, _one, lambda B: B <= 32768, 2),
    "u8cmp": VariantSpec(
        "u8cmp", "uint8 compare", stack_rows,
        _geom_plain, _one, lambda B: B <= 256, 3),
    "sub1abs": VariantSpec(
        "sub1abs", "onehot = max(0, 1 - |b - j|) in bf16 (no compare)",
        stack_rows, _geom_plain, _one, lambda B: B <= 256, 4),
    "staged": VariantSpec(
        "staged", "hi-digit one-hot * lo-digit one-hot (digit width 16)",
        stack_rows, _geom_plain, _one, lambda B: True, 5),
    "packed": VariantSpec(
        "packed", "k=128//B features per 128-lane group (B <= 64, B | 128)",
        stack_rows, lambda B, Bp: 128, lambda B, Bp: 128 // B,
        lambda B: pack_k(B) >= 2, 6),
    "int8": VariantSpec(
        "int8", "int8 one-hot, per-block 3-level quantized gh, int32 sums",
        prep_f32, _geom_plain, _one, lambda B: True, 7),
}

VARIANT_NAMES = tuple(VARIANTS)

# candidates the election times (pick_variant): one entrant per family
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
    """Output lanes of one feature: ``Bp``, a multiple of 128 (not a power
    of two above 256 bins: 384 at B = 300, 2,688 at B = 2,599), or ``B``
    under lane packing (a power of two that divides 128)."""
    Bp = padded_bins(B)
    return spec.group_lanes(B, Bp) // spec.group_feats(B, Bp)


def resolve(name: str, max_bin: int) -> str:
    """Validate ``name`` against the registry and the kernel bin width;
    returns a supported variant name (falling back to 'base' with a warning
    when the requested family cannot serve this width, as the JAX package
    does)."""
    if name not in VARIANTS:
        raise ValueError(f"unknown hist_variant {name!r}; "
                         f"known: {', '.join(VARIANT_NAMES)}")
    if not VARIANTS[name].supports(max_bin):
        Log.warning("hist_variant=%s does not support max_bin=%d; "
                    "using 'base'", name, max_bin)
        return "base"
    return name


def finish_hist(out: torch.Tensor, f: int, B: int, Bp: int,
                spec: VariantSpec) -> torch.Tensor:
    """``[..., 6, lanes]`` kernel output -> ``[..., f, B, 3]`` histograms:
    sum the (hi, lo) triples and undo the lane layout (plain ``Bp``-wide
    slots, or the packed ``group*128 + f_local*B + bin`` layout).  A
    ``[..., 3, lanes]`` output (the bucketed kernels', which add hi and lo
    themselves) is taken as the sums.  Keeps the input's dtype."""
    gl = spec.group_lanes(B, Bp)
    gf = spec.group_feats(B, Bp)
    lead = tuple(out.shape[:-2])
    ng = out.shape[-1] // gl
    if out.shape[-2] == 3:
        hist = out.reshape(lead + (3, ng, gl))
    else:
        o = out.reshape(lead + (2, 3, ng, gl))
        hist = o[..., 0, :, :, :] + o[..., 1, :, :, :]   # [..., 3, ng, gl]
    hist = hist[..., :gf * B].reshape(lead + (3, ng * gf, B))
    hist = hist[..., :f, :]
    return torch.movedim(hist, -3, -1)                   # [..., f, B, 3]


# --------------------------------------------------------------------------
# the Pallas kernels' row blocks, and the int8 quantizer
# --------------------------------------------------------------------------

# the JAX package's _hist_pallas geometry (lightgbm_tpu/ops/histogram.py):
# default rows per grid step, output lanes per feature block, and the
# one-hot tile's VMEM budget that caps the rows per step
PALLAS_BLOCK_ROWS = 1024
PALLAS_BLOCK_LANES = 2048
PALLAS_ONEHOT_BYTES = 8 * 1024 * 1024


def pallas_block_rows(variant: str, layout: str, n: int, f: int,
                      max_bin: int) -> int:
    """Rows per grid step ``BR`` of the JAX package's ``_hist_pallas`` for
    ``n`` rows of ``f`` features (the ``kernel_fm`` arithmetic for
    ``featmajor``, ``kernel_rm``'s for ``rowmajor``).  For ``int8`` this is
    the quantization block, on which the scales and so the result depend:
    1024 at 1M x 28 featmajor (B=256 or 64), 512 rowmajor at f=28, B=256.
    Block ``i`` is rows ``[i·BR, (i+1)·BR)`` by absolute index."""
    spec = VARIANTS[variant]
    Bp = padded_bins(max_bin)
    gf = spec.group_feats(max_bin, Bp)
    lpf = spec.group_lanes(max_bin, Bp) // gf
    if layout == "rowmajor":
        lanes = f * lpf
    elif layout == "featmajor":
        align = max(8, gf)
        lanes = max(align, (PALLAS_BLOCK_LANES // lpf) // align * align) * lpf
    else:
        raise ValueError(f"unknown histogram layout {layout!r}")
    br_cap = max(128, (PALLAS_ONEHOT_BYTES // (2 * lanes)) // 128 * 128)
    return max(128, min(PALLAS_BLOCK_ROWS, br_cap, -(-n // 128) * 128))


# float32 1/127: the JAX package's ``max|x| / 127.0`` compiles (XLA's
# algebraic simplifier) to a multiply by this constant
RECIP_127 = 0.007874015718698502          # 0x3C010204
_TINY = 1e-30


def quantize_int8_blocks_plain(rows: torch.Tensor, block_rows: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 variant's three-level quantization of ``rows [3, N]``
    float32, per block of ``block_rows`` rows (the JAX package's ``level``
    chain in ``_contrib_int8``; the last block is padded with zeros).  Per
    block and row: ``s = max(max|x| · f32(1/127), 1e-30)``, ``q =
    round(x / s)`` (half to even), ``r = x - q·s`` rounded once, as XLA's
    fused multiply-add gives it; the next level quantizes ``r``.  A
    non-finite ``x`` gives a NaN ``q``, stored as 0 (its scales are
    non-finite, which makes its channel NaN in the histogram).

    Returns ``q [9, N]`` int8 (level-major: rows ``3·level + channel``) and
    ``s [nblocks, 9]`` float32."""
    c, n = rows.shape
    br = int(block_rows)
    nb = -(-n // br)
    x = torch.zeros(c, nb * br, dtype=torch.float32, device=rows.device)
    x[:, :n] = rows
    x = x.view(c, nb, br).transpose(0, 1)                   # [nb, 3, br]
    recip = torch.full((1, 1, 1), RECIP_127, dtype=torch.float32,
                       device=rows.device)
    tiny = torch.full((1, 1, 1), _TINY, dtype=torch.float32,
                      device=rows.device)
    qs, ss = [], []
    for _ in range(3):
        s = torch.maximum(x.abs().amax(dim=2, keepdim=True) * recip, tiny)
        q = torch.round(x / s)
        # q·s is exact in float64, and so is x - q·s: one rounding to float32
        r = (x.double() - q.double() * s.double()).float()
        qs.append(torch.where(torch.isnan(q), 0.0, q))
        ss.append(s[..., 0])
        x = r
    q = torch.cat(qs, 1).transpose(0, 1).reshape(3 * c, nb * br)[:, :n]
    return (q.to(torch.int8).contiguous(),
            torch.cat(ss, 1).contiguous())


# --------------------------------------------------------------------------
# single-feature-block bench kernel (the shootout's shell)
# --------------------------------------------------------------------------

def make_bench_kernel(variant: str, f: int, max_bin: int, BR: int):
    """(prep, run) for the timing shootout: ``rows = prep(g, h, m)`` once
    outside the timed loop, then ``run(bins_t [f, N] u8, rows)`` is the
    timed kernel -- feature-major, bins transposed by the caller, ``N`` a
    multiple of ``BR`` (the quantization block of ``int8``).  Returns
    finished ``[f, B, 3]`` histograms.  ``run`` launches the
    ``onehot_bench`` kernel entry on CUDA tensors (after the quantize
    kernel, for int8) and the plain version on CPU tensors."""
    from .histogram import hist_onehot_bench

    def run(bins_t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        if bins_t.shape[0] != f:
            raise ValueError(f"bench kernel built for {f} features, got "
                             f"bins_t of shape {tuple(bins_t.shape)}")
        return hist_onehot_bench(bins_t, rows, max_bin, variant=variant,
                                 block_rows=BR)

    return VARIANTS[variant].prep, run


# --------------------------------------------------------------------------
# the election (hist_variant=auto)
# --------------------------------------------------------------------------

# (device name, width) -> elected variant
_AUTO_CACHE: Dict[tuple, str] = {}
# (device name, width) -> {candidate: {"ms", "relerr", "qualified"}}, what
# each election measured (read by the smoke test; not consulted)
AUTO_RESULTS: Dict[tuple, dict] = {}


def _auto_bench_data(max_bin: int, f: int, device: torch.device,
                     rows: int = 262144):
    """Synthetic (bins, g, h, m) for the election, the JAX package's: the
    width is clipped to 8..128, since the ranking is what matters.  Bins
    are ``uint8`` up to 256 bins and ``uint16`` above, as the bin matrix
    holds them (the JAX package draws ``uint8`` at every width, which
    numpy refuses above 256)."""
    f = max(8, min(f, 128))
    rng = np.random.default_rng(0)
    dtype = np.uint8 if max_bin <= 256 else np.uint16
    bins = rng.integers(0, max_bin, size=(rows, f), dtype=dtype)
    g = rng.normal(size=rows).astype(np.float32)
    h = np.full(rows, 0.25, np.float32)
    m = np.ones(rows, np.float32)
    return [torch.as_tensor(a).to(device) for a in (bins, g, h, m)]


def _time_auto_candidate(variant, bins, g, h, m, max_bin, ref,
                         iters: int = 5):
    """(seconds per pass, relerr against ``ref``) of one candidate on the
    card, through ``hist_onehot_full`` in the root histogram's layout.  A
    build or launch failure raises (a fault of the port, not a loss)."""
    from .histogram import hist_onehot_full

    def run():
        return hist_onehot_full(bins, g, h, m, max_bin, variant=variant,
                                layout="featmajor")
    out = run()                                        # build + warm
    err = float(((out - ref).abs() / (ref.abs() + 1.0)).max())
    torch.cuda.synchronize(bins.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize(bins.device)
    return (time.perf_counter() - t0) / iters, err


def _auto_key(device: torch.device, max_bin: int) -> tuple:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return (name, int(max_bin))


def pick_variant(max_bin: int, num_features: int, *, device) -> str:
    """``hist_variant=auto``: on a CUDA device, a one-time micro-bench on
    the card elects the fastest parity-clean candidate for this (card,
    width), cached at module scope so later fits reuse it without timing
    again.  On the CPU the kernels are not the path, so 'base' is returned
    without timing anything (as the JAX package does off the TPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "base"
    key = _auto_key(dev, max_bin)
    if key in _AUTO_CACHE:
        return _AUTO_CACHE[key]
    choice = _run_auto_bench(max_bin, num_features, dev)
    _AUTO_CACHE[key] = choice
    return choice


def _run_auto_bench(max_bin: int, num_features: int,
                    device: torch.device) -> str:
    """Elect the variant: every supported AUTO_CANDIDATE is first held
    against the exact float64 scatter (``hist_full_plain``) at
    ``HIST_PARITY_TOL`` before its time counts; the fastest parity-clean
    candidate wins, 'base' when none is.  A parity failure disqualifies
    the candidate with a warning; a build or launch failure raises."""
    from .histogram import HIST_PARITY_TOL, hist_full_plain

    bins, g, h, m = _auto_bench_data(max_bin, max(1, num_features), device)
    ref = hist_full_plain(bins, g, h, m, max_bin)
    results = AUTO_RESULTS[_auto_key(device, max_bin)] = {}
    best, best_t = "base", float("inf")
    for name in AUTO_CANDIDATES:
        if not VARIANTS[name].supports(max_bin):
            continue
        t, err = _time_auto_candidate(name, bins, g, h, m, max_bin, ref)
        ok = err <= HIST_PARITY_TOL
        results[name] = {"ms": t * 1e3, "relerr": err, "qualified": ok}
        if not ok:
            Log.warning("hist_variant auto-tune: %s FAILED on-device parity "
                        "(relerr %.2e > %.0e) -- disqualified", name, err,
                        HIST_PARITY_TOL)
            continue
        Log.info("hist_variant auto-tune: %s %.3f ms (relerr %.2e)", name,
                 t * 1e3, err)
        if t < best_t:
            best, best_t = name, t
    Log.info("hist_variant auto-tune: picked %s for max_bin=%d", best,
             max_bin)
    return best
