"""Where the time of the PyTorch port's atomic histogram kernels goes, on
one NVIDIA card.

    python3 scripts/torch_atomic_ablation.py [--copies NAME,...] [--wide]
        [--wide-bins] [--out PATH]

Builds ``hist_full`` and ``hist_leaves`` (``lightgbm_tpu_torch/ops/
kernels``) from the sources as they are and from copies with one part of
the work taken out, and times each at ``chip_smoke.py``'s shapes: the full
pass (1M x 28, B=256) and one frontier round's leaves (C=262,144, NC=40,
f=28, k=16, BR=512) with three inputs: the random block->slot map, the
same blocks laid out slot by slot as the frontier lays a round out
(``slot_ordered``), and that layout with skewed bins (``skewed``: every
row of feature 0 in one bin, feature 1 in four).  A copy edits the sources
as text (each edit must match exactly once, or the script stops) and is
built with the port's ``nvcc`` flags into ``ops/_build/ablation/atomic/
<name>/``; what a copy computes is wrong on purpose, only its time is read.
The kernels have two designs of the update (``ops/kernels/
hist_common.cuh``): owned (a warp a feature, the plan's choice at B=256)
and dealt (every warp takes (step, feature) items, grouped by a warp
sort and applied in step order through a ticket a feature; the plan's
choice at wide bins).

  repo         the sources as they are
  no_update    the histogram is never updated (both designs): staging,
               bin reads, the grouping of lanes and the loop stay
  no_atomic    owned: no grouping of lanes that share a bin: every lane
               adds its own row with a plain read-add-write, so lanes
               race (wrong)
  no_grouping  dealt: no sort, so only lanes next to each other that
               share a bin are grouped and the others race (wrong)
  no_ticket    dealt: no wait for the feature's ticket, so items of one
               feature race (wrong)
  no_items     dealt: the item warps take no items: the ring's staging,
               the partials and the reduce pass alone
  no_flush     no partial is written (the reduce pass still runs)

``--wide`` also times the sources as they are on wide rows, each feature
group read apart: the full pass at 500,000 x 700 and 200,000 x 2,000, and
the leaves (C=262,144, slot-ordered, k=16, BR=512) at f=700 and 2,000
(rows of f + 12 bytes), all at B=256.  ``--wide-bins`` times every copy
at the u16 widths: the full pass at 1M x 28, B=1,024 (``max_bin=1023``),
with random bins (a tenth of them past B, dropped) and with Zipf-skewed
bins (bin i with weight 1/(i+1)^1.1), one frontier round's leaves at
B=1,024 (28 u16 features and 6 gh columns, k=16, BR=512, slot-ordered),
and ``chip_smoke.py``'s sparse_efb
bundle matrix (Allstate width, ``make_allstate_like`` through
``breadth_data``: 250k x 35 bundle columns, B=2,599) full and per leaf
(its rows as one frontier round's comb, k=16, BR=512, slot-ordered).
``--copies repo`` needs no edit, so the script also times an older
checkout's kernels through that checkout's own wrappers: copy it into
that checkout's ``scripts/`` and run it from there, in the same call as
this one.

Kernel time: torch.profiler's device time per call (mean of 10 calls) of
the ``hist_*_kernel`` and ``hist_reduce_kernel`` launches, without the
wrapper's other torch ops; for the sources as they are also the time of a
whole call, wrapper included (median of 20, CUDA events, as
``chip_smoke.py``'s ``ms``), the error against the plain version, and
``index_add_``'s time, and where the wrappers offer ``atomic_design``,
the kernel-alone time of the design the plan did not pick; registers a
thread and spilled bytes from ``ptxas -v``, per instantiation (bin type
and design) where the sources have both designs.  Prints the card's name and power limit, then one JSON line per
copy, and writes them all to ``chiprun_out/atomic_ablation.json`` (or
``--out``).  Exits non-zero without a CUDA card.
"""
import argparse
import itertools
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (file, old, new) text edits of the kernel sources, each matching once
EDITS = {
    "no_update": [(
        "hist_common.cuh",
        "      if (lead) add_entry(hist + ((long long)f * bw + key) * 3, v0, v1, "
        "v2);\n",
        "      if (lead && v0 == -1234.5) hist[0] = v1 + v2;\n"), (
        "hist_common.cuh",
        "    add_entry(hist + ((long long)f * bw + a.key) * 3, a.v0, a.v1, "
        "a.v2);\n",
        "    if (a.v0 == -1234.5) hist[0] = a.v1 + a.v2;\n"), (
        "hist_common.cuh",
        "    add_entry(hist + ((long long)f * bw + b.key) * 3, b.v0, b.v1, "
        "b.v2);\n",
        "    if (b.v0 == -1234.5) hist[0] = b.v1 + b.v2;\n")],
    "no_atomic": [(
        "hist_common.cuh",
        "      const uint32_t peers = group_peers(wm, key, below);\n",
        "      const uint32_t peers = key != kNoBin ? below + 1u : 0u;\n")],
    "no_grouping": [(
        "hist_common.cuh",
        "    warp_sort2(wa, wb, lane);\n",
        "")],
    "no_ticket": [(
        "hist_common.cuh",
        "  while (ld_acquire(tickets + f) != s) {\n  }\n",
        "")],
    "no_items": [(
        "hist_common.cuh",
        "      const int items = ((nrows + 63) >> 6) * fg;\n",
        "      const int items = 0 * fg * nrows;\n")],
    "no_flush": [(
        "hist_common.cuh",
        "  for (int i = threadIdx.x; i < n2; i += blockDim.x) dst2[i] = "
        "src2[i];\n",
        "  if (n2 < 0) dst2[threadIdx.x] = src2[threadIdx.x];\n")],
}
ABLATIONS = ("repo",) + tuple(EDITS)
KERNELS = ("hist_full", "hist_leaves")
# the kernels a call launches, by the names the profiler gives them (an
# older checkout's zero-fill and cast are its wrapper's)
KERNEL_NAMES = {"hist_full": ("hist_full_kernel", "hist_reduce_kernel"),
                "hist_leaves": ("hist_leaves_kernel", "hist_reduce_kernel")}
B = 256
# --wide: the full pass's (rows, features), the leaves' features
WIDE_FULL = ((500_000, 700), (200_000, 2000))
WIDE_LEAVES = (700, 2000)
# --wide-bins: B of the full pass at 1M x 28 and the Zipf exponent of its
# skewed bins
WIDE_B = 1024
ZIPF_A = 1.1


def ablation_edits(name):
    """The text edits of one copy."""
    return [] if name == "repo" else EDITS[name]


def _patched_sources(name, edits, kernel_dir, out_dir):
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(kernel_dir, out_dir)
    for fn, old, new in edits:
        path = os.path.join(out_dir, fn)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit of {fn} matches "
                               f"{text.count(old)} times, not once: "
                               f"{old[:60]!r}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))


def _ptxas(log, kernel):
    """(registers, spilled bytes) of the kernel whose mangled name holds
    ``kernel``, from ``ptxas -v``'s output."""
    regs = spill = None
    current = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            current = m.group(1)
        if current is None or kernel not in current:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs = int(m.group(1))
    return regs, spill


def build_all(_build, names):
    """{(copy, kernel): (ctypes library, ptxas log)}, one nvcc each, all at
    once."""
    import ctypes
    root = _build.BUILD_DIR / "ablation" / "atomic"
    procs = {}
    for name in names:
        src = root / name
        _patched_sources(name, ablation_edits(name),
                         str(_build.KERNEL_DIR), str(src))
        for k in KERNELS:
            out = src / f"{k}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                   str(src / _build.KERNELS[k])]
            procs[name, k] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    libs = {}
    for key, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{key}: nvcc exit {p.returncode}\n{log}")
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in _build._ARGTYPES[key[1]].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lgbt_error_string.argtypes = [ctypes.c_int]
        lib.lgbt_error_string.restype = ctypes.c_char_p
        libs[key] = (lib, log)
    return libs


def device_ms(fn, names, reps=10):
    """Device time per call of the kernels whose names hold one of
    ``names`` (torch.profiler over ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and any(n in e.key for n in names)]
    return sum(cs._device_us(e) for e in rows) / 1e3 / reps


def skewed_bins(comb):
    """Every row of feature 0 in one bin, feature 1 in four."""
    out = comb.clone()
    out[:, 0] = 7
    out[:, 1] = (comb[:, 1] & 3) * 60 + 3
    return out


def _hold(row, key, got, again, ref):
    """The error of a call against the plain version, its NaNs, and the
    same bits from a second call."""
    fin = torch.isfinite(ref)
    row[f"{key}/relerr"] = cs.relerr(got[fin], ref[fin])
    row[f"{key}/nan_equal"] = bool(torch.equal(torch.isnan(got),
                                               torch.isnan(ref)))
    row[f"{key}/same_bits_twice"] = bool(torch.equal(got[fin], again[fin]))
    row[f"{key}/bit_identical_share"] = float(
        (got[fin] == ref[fin]).float().mean())


def smoke_calls(hist, dev, gen):
    """{key: (call, library_ms)} at chip_smoke.py's shapes."""
    n, f = cs.N_TRAIN, cs.N_FEAT
    bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = cs._rows(gen, n, dev)
    k, BR, fl = (cs.LEAVES_SHAPE[x] for x in ("k", "BR", "f"))
    comb, lg, lh, lm, block_leaf, _, _ = cs._leaves_inputs(gen, dev)
    ordered = torch.sort(block_leaf).values
    leaves_in = {"random": (comb, block_leaf),
                 "slot_ordered": (comb, ordered),
                 "skewed": (skewed_bins(comb), ordered)}
    calls = {"hist_full": (lambda: hist.hist_full(bins, g, h, m, B),
                           cs._full_yardstick(dev, bins, g, h, m, B))}
    for case, (c, bl) in leaves_in.items():
        calls[f"hist_leaves/{case}"] = (
            lambda c=c, bl=bl: hist.hist_leaves(c, lg, lh, lm, bl, k, B,
                                                block_rows=BR, f_limit=fl),
            cs._leaves_yardstick(dev, c, lg, lh, lm, bl, k, B, BR, fl))
    return calls


def wide_call(hist, dev, gen, key):
    """(call, library_ms) of one --wide shape: ``hist_full/NxF`` or
    ``hist_leaves/fF``."""
    kern, shape = key.split("/")
    if kern == "hist_full":
        n, f = (int(x) for x in shape.split("x"))
        bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                             dtype=torch.uint8)
        g, h, m = cs._rows(gen, n, dev)
        return (lambda: hist.hist_full(bins, g, h, m, B),
                cs._full_yardstick(dev, bins, g, h, m, B))
    f = int(shape[1:])
    C, k, BR = cs.LEAVES_SHAPE["C"], cs.LEAVES_SHAPE["k"], 512
    comb = torch.randint(0, B, (C, f + 12), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = cs._rows(gen, C, dev)
    bl = torch.sort(torch.randint(0, k, (C // BR,), generator=gen,
                                  device=dev, dtype=torch.int32)).values
    return (lambda: hist.hist_leaves(comb, g, h, m, bl, k, B, block_rows=BR,
                                     f_limit=f),
            cs._leaves_yardstick(dev, comb, g, h, m, bl, k, B, BR, f))


def zipf_u16(gen, dev, shape, B, a=ZIPF_A):
    """u16 bins in [0, B), bin i drawn with weight 1/(i+1)^a."""
    p = 1.0 / torch.arange(1, B + 1, device=dev, dtype=torch.float64) ** a
    idx = torch.multinomial(p.float(), shape[0] * shape[1],
                            replacement=True, generator=gen)
    return idx.view(shape).to(torch.int16).view(torch.uint16)


def wide_bins_calls(hist, dev, gen):
    """{key: (call, library_ms)} at the u16 widths (see the top)."""
    n, f, B = cs.N_TRAIN, cs.N_FEAT, WIDE_B
    g, h, m = cs._rows(gen, n, dev)
    calls = {}
    for case, bins in (("random", cs._u16(gen, (n, f), B + 60, dev)),
                       ("zipf", zipf_u16(gen, dev, (n, f), B))):
        calls[f"hist_full/u16/B{B}/{case}"] = (
            lambda bins=bins: hist.hist_full(bins, g, h, m, B),
            cs._full_yardstick(dev, bins, g, h, m, B))
    k, BR = cs.LEAVES_SHAPE["k"], cs.LEAVES_SHAPE["BR"]
    C = cs.LEAVES_SHAPE["C"]
    cg, ch, cm = cs._rows(gen, C, dev)
    comb = cs._frontier_comb(cs._u16(gen, (C, f), B + 60, dev), cg, ch, cm)
    cbl = torch.sort(torch.randint(0, k, (C // BR,), generator=gen,
                                   device=dev)).values.to(torch.int32)
    calls[f"hist_leaves/u16/B{B}"] = (
        lambda comb=comb: hist.hist_leaves(comb, cg, ch, cm, cbl, k, B,
                                           block_rows=BR, f_limit=f),
        cs._leaves_yardstick(dev, comb, cg, ch, cm, cbl, k, B, BR, f))
    data = cs.breadth_data()
    bins, Bb = data["bins"], int(data["bundle_bins"])
    nc = bins.shape[1]
    bg, bh, bm = cs._rows(gen, bins.shape[0], dev)
    calls["hist_full/u16/bundle"] = (
        lambda: hist.hist_full(bins, bg, bh, bm, Bb),
        cs._full_yardstick(dev, bins, bg, bh, bm, Bb))
    rows = torch.randperm(bins.shape[0], generator=gen, device=dev)[
        :min(C, bins.shape[0] // BR * BR)]
    C = rows.numel()
    lg, lh, lm = cs._rows(gen, C, dev)
    comb = cs._frontier_comb(hist.take_rows(bins, rows), lg, lh, lm)
    bl = torch.sort(torch.randint(0, k, (C // BR,), generator=gen,
                                  device=dev)).values.to(torch.int32)
    calls["hist_leaves/u16/bundle"] = (
        lambda: hist.hist_leaves(comb, lg, lh, lm, bl, k, Bb, block_rows=BR,
                                 f_limit=nc),
        cs._leaves_yardstick(dev, comb, lg, lh, lm, bl, k, Bb, BR, nc))
    return calls


def time_exact(row, hist, key, fn, library_ms):
    """Kernel alone, the call, index_add_ and the error of an exact copy,
    and the kernel alone in the design the plan did not pick."""
    kern = key.split("/")[0]
    row[f"{key}/kernel_ms"] = device_ms(fn, KERNEL_NAMES[kern])
    if hasattr(hist, "atomic_design"):
        plan = next(iter(hist._plans.values()))
        other = hist.ATOMIC_DESIGNS[1 - plan["design"]]
        row[f"{key}/design"] = hist.ATOMIC_DESIGNS[plan["design"]]
        row[f"{key}/fg"] = plan["fg"]
        row[f"{key}/warps_per_sm"] = plan["threads"] // 32 * plan[
            "ctas_per_sm"]
        hist._plans.clear()
        with hist.atomic_design(other):
            row[f"{key}/{other}_kernel_ms"] = device_ms(fn, KERNEL_NAMES[kern])
        hist._plans.clear()
    with hist.force_plain():
        ref = fn()
    got, again = fn(), fn()
    torch.cuda.synchronize()
    _hold(row, key, got, again, ref)
    del ref, got, again
    row[f"{key}/ms"] = cs.median_ms(fn)
    row[f"{key}/library_ms"] = library_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--copies", default=",".join(ABLATIONS),
                    help="the copies to build and time")
    ap.add_argument("--wide", action="store_true",
                    help="also time the sources as they are on wide rows")
    ap.add_argument("--wide-bins", action="store_true",
                    help="also time every copy at the u16 widths")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "atomic_ablation.json"))
    args = ap.parse_args()
    names = tuple(args.copies.split(","))
    if not torch.cuda.is_available():
        print("torch_atomic_ablation: no CUDA device", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import histogram as hist
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_all(_build, names)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls = smoke_calls(hist, dev, gen)
    if args.wide_bins:
        calls.update(wide_bins_calls(hist, dev, gen))
    wide = ([f"hist_full/{n}x{f}" for n, f in WIDE_FULL]
            + [f"hist_leaves/f{f}" for f in WIDE_LEAVES]) if args.wide else []
    rows = []
    saved = dict(_build._LIBS)
    try:
        for name in names:
            row = {"ablation": name, "card": smi, "B": B}
            getattr(hist, "_plans", {}).clear()
            for kern in KERNELS:
                lib, log = libs[name, kern]
                _build._LIBS[kern] = lib
                regs, spill = _ptxas(log, f"{kern}_kernel")
                row[f"{kern}/registers"] = regs
                row[f"{kern}/spill_bytes"] = spill
                for (bt, tc), (dn, dc) in itertools.product(
                        (("u8", "h"), ("u16", "t")),
                        (("owned", "Lb0E"), ("dealt", "Lb1E"))):
                    regs, spill = _ptxas(log, f"{kern}_kernelI{tc}{dc}")
                    if regs is not None:
                        row[f"{kern}/{bt}/{dn}/registers"] = regs
                        row[f"{kern}/{bt}/{dn}/spill_bytes"] = spill
            for key, (fn, library_ms) in calls.items():
                getattr(hist, "_plans", {}).clear()
                if name == "repo":
                    time_exact(row, hist, key, fn, library_ms)
                else:
                    row[f"{key}/kernel_ms"] = device_ms(
                        fn, KERNEL_NAMES[key.split("/")[0]])
            if name == "repo":
                for key in wide:        # one shape's tensors at a time
                    getattr(hist, "_plans", {}).clear()
                    time_exact(row, hist, key, *wide_call(hist, dev, gen,
                                                          key))
                    torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        _build._LIBS.clear()
        _build._LIBS.update(saved)
        getattr(hist, "_plans", {}).clear()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
