"""Where the time of the PyTorch port's one-hot kernels goes, on one
NVIDIA card.

    python3 scripts/torch_onehot_ablation.py [--copies NAME,...] [--sweep]
        [--bodies NAME,...] [--width B] [--bundle] [--int8-body words|lanes]
        [--out PATH]

Builds ``onehot_full`` and ``onehot_leaves`` (``lightgbm_tpu_torch/ops/
kernels``) from the sources as they are and from copies with one part of
the work taken out, and times each body's kernel alone at
``chip_smoke.py``'s shapes: the full pass (1M x 28, featmajor and
rowmajor) and one frontier round's leaves (C=262,144, NC=40, f=28, k=16,
BR=512, the block map and NaN block of ``chip_smoke.py``), B=256, for
``base``, ``bf16cmp``, ``staged`` and ``int8``.  A copy edits
``onehot_common.cuh`` and ``onehot_bucket.cuh`` as text (each edit must
match exactly once in the two, or the script stops) and is built with the
port's ``nvcc`` flags into ``ops/_build/ablation/<name>/``; what a copy
computes is wrong on purpose, only its time is read.

  repo        the sources as they are
  const_a     each tile's A fragment is a constant: no bin word read and
              no one-hot built; staging, split, sort, mma and fold stay
  no_mma      each mma.sync (bf16 and int8) becomes an XOR of its six
              operands into its first sum: the one-hot build stays live,
              the tensor cores do nothing
  skeleton    const_a and no_mma together: staging, split, loop and fold
  no_sort     the bucketed design (u16) without its sort: no ballot ranks
              and no compacted rows written; each warp counts its 64 rows
              as spread evenly over its (bucket, tile) keys (int8: over
              every nblk-th of its (block, bucket, tile) keys), so the
              plan and the multiply keep their work on uniform bins

``--width`` above 256 (u16 bins; default bodies ``base``, ``i16cmp``,
``staged``, ``int8``) times the u16 shapes instead: the full pass at 1M x
28 with random bins (a tenth past B, dropped), featmajor and rowmajor, and
with Zipf-skewed bins (bin i with weight 1/(i+1)^1.1), featmajor; the
leaves at C=262,144 (28 u16 features and 6 gh columns, k=16, BR=512, the
block map of ``chip_smoke.py``) with random and Zipf-skewed bins; with
``--bundle`` also ``chip_smoke.py``'s sparse_efb bundle matrix
(``breadth_data``: 250k x 35 bundle columns, B=2,599), featmajor.

``--copies`` names the copies to build and time (default: all five);
``--bodies`` and ``--width`` the bodies and the bin width B (default the
four above at 256; ``packed`` needs a width it serves, such as 64);
``--copies repo`` edits nothing, so copied into an older checkout it
times that checkout's kernels through its own wrappers, side by side
with this one in the same call.  Where the wrappers offer
``onehot_design``, the sources as they are are also timed in the design
the plan did not pick (at u16: the dense design of PRs 5-6).

With ``--sweep`` it also times int8 alone from copies of the sources as
they are whose dense int8 kernels bound their registers for 2, 3 or 4
resident CTAs an SM (``kInt8MinBlocks``, ``kInt8LeavesMinBlocks``; the
sources say 3 for ``onehot_full``, 4 for ``onehot_leaves``).

The int8 edits fit the int8 body the sources hold: ``words`` (the default:
one bin word per k-half a step, the one-hot built as ``Int8Step::tile``)
or ``lanes`` (the earlier body: per-lane offset tables, the one-hot built
by ``onehot4``), so that a checkout of the earlier sources can be timed
side by side with this one: run this script from that checkout's root
with ``--int8-body lanes``.

The float64 fold cannot be taken out alone: with its sums unused, ptxas
deletes the mma instructions as dead code (the asm's volatile does not
reach it) and the build with them, so such a copy times almost nothing.
The skeleton bounds it.

Kernel time: torch.profiler's device time per launch (mean of 10 calls),
as ``chip_smoke.py``'s ``kernel_ms``; for the sources as they are also the
time of a whole call, wrapper included (median of 20, CUDA events, as
``chip_smoke.py``'s ``ms``), the error against the plain version and the
same bits from two calls, ``index_add_``'s time on the same inputs, and
registers a thread and spilled bytes from the kernels' attribute query.
Prints one JSON line per copy and writes them all to
``chiprun_out/onehot_ablation.json`` (or ``--out``).  Exits non-zero
without a CUDA card.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

# (old, new) text edits of the edited sources (EDITED), each matching
# exactly once in them
EDITED = ("onehot_common.cuh", "onehot_bucket.cuh")
_CONST_A = [
    (f"  const Step<V> {s}(load4(bp), ids);\n", "") for s in ("s", "st")] + [
    (f"    {s}.tile(tl, a);\n",
     "    a[0] = a[1] = a[2] = a[3] = kOneLo * (uint32_t)(tl + 1);\n")
    for s in ("s", "st")]
_NO_MMA = [
    ("template <bool kFirst = false>\n"
     "__device__ __forceinline__ void mma16816(",
     "template <bool kFirst = false>\n"
     "__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,\n"
     "    uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {\n"
     "  const float x = __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1);\n"
     "  if (kFirst) { d[0] = x; d[1] = d[2] = d[3] = 0.f; }\n"
     "  else d[0] += x;\n"
     "}\n"
     "template <bool kFirst = false>\n"
     "__device__ __forceinline__ void mma16816_unused("),
]
# the int8 body's: its one-hot (per body; ``words`` in both designs) and
# its mma.sync (both bodies)
_INT8_TILE = ("      o.tile(tl, a);\n"
              "      mma16832(c[tl][0], a[0], a[1], a[2], a[3], b.x, b.y);\n"
              "      mma16832(c[tl][1], a[0], a[1], a[2], a[3], {0}.x, "
              "{0}.y);\n")
_INT8_CONST_A = {
    "words": [(_INT8_TILE.format(b), _INT8_TILE.format(b).replace(
        "      o.tile(tl, a);\n",
        "      a[0] = a[1] = a[2] = a[3] = kTop >> tl;\n"))
              for b in ("b8", "b1")],
    "lanes": [("  return j < 0 ? 0u : (__vcmpeq4(v, (uint32_t)j * "
               "0x01010101u) & 0x01010101u);\n",
               "  return 0x01010101u;\n")],
}
_INT8_NO_MMA = [
    ("__device__ __forceinline__ void mma16832(int (&d)[4], uint32_t a0,\n",
     "__device__ __forceinline__ void mma16832(int (&d)[4], uint32_t a0,\n"
     "    uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {\n"
     "  d[0] += (int)(a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1);\n"
     "}\n"
     "__device__ __forceinline__ void mma16832_unused(int (&d)[4], "
     "uint32_t a0,\n"),
]
_NO_SORT = [
    ("    rank_rows(P, key, rank, kTiles * nbc);\n",
     "    for (int k = tid & 31; k < kTiles * nbc; k += 32)\n"
     "      P.off[wp][k] = kSegRows / kBWarps / (kTiles * nbc);\n"),
    ("    place_rows<V>(sh, P, key, rank, p, w, b0, nbc, dense, mine);\n",
     ""),
    ("    rank_blocks(P.off[wp], key, rank, nblk);\n",
     "    for (int k = lane; k < nblk * kKeys; k += 32)\n"
     "      P.off[wp][k] = k % nblk == 0;\n"),
    ("      if (key[i] >= 0)\n        put_row<kInt8Span>(",
     "      if (key[i] < -1)\n        put_row<kInt8Span>("),
]
ABLATIONS = ("repo", "const_a", "no_mma", "skeleton", "no_sort")
INT8_BODIES = tuple(_INT8_CONST_A)
# --sweep: the sources as they are with both dense int8 kernels' register
# bound sized for 2, 3 or 4 CTAs an SM (the sources say 3 for onehot_full
# and 4 for onehot_leaves); int8 only
SWEEP = {f"int8_min_blocks_{b}": [
    ("constexpr int kInt8MinBlocks = 3;\n",
     f"constexpr int kInt8MinBlocks = {b};\n"),
    ("constexpr int kInt8LeavesMinBlocks = 4;\n",
     f"constexpr int kInt8LeavesMinBlocks = {b};\n")] for b in (2, 3, 4)}
KERNELS = ("onehot_full", "onehot_leaves")
BODIES = ("base", "bf16cmp", "staged", "int8")
U16_BODIES = ("base", "i16cmp", "staged", "int8")
B = 256


def ablation_edits(name, int8_body="words"):
    """The text edits of one copy, for sources holding ``int8_body``."""
    if name in SWEEP:
        return SWEEP[name]
    const_a = _CONST_A + _INT8_CONST_A[int8_body]
    no_mma = _NO_MMA + _INT8_NO_MMA
    return {"repo": [], "const_a": const_a, "no_mma": no_mma,
            "skeleton": const_a + no_mma, "no_sort": _NO_SORT}[name]


def _patched_sources(name, edits, kernel_dir, out_dir):
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(kernel_dir, out_dir)
    texts = {}
    for fn in EDITED:
        path = os.path.join(out_dir, fn)
        if os.path.exists(path):
            with open(path) as fh:
                texts[fn] = fh.read()
    for old, new in edits:
        hits = [fn for fn, t in texts.items() for _ in range(t.count(old))]
        if len(hits) != 1:
            raise RuntimeError(f"{name}: an edit matches {len(hits)} "
                               f"times, not once: {old[:60]!r}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for fn, t in texts.items():
        with open(os.path.join(out_dir, fn), "w") as fh:
            fh.write(t)


def build_all(_build, names, int8_body="words"):
    """{(copy, kernel): ctypes library}, one nvcc each, all at once."""
    import ctypes
    root = _build.BUILD_DIR / "ablation"
    procs = {}
    for name in names:
        src = root / name
        _patched_sources(name, ablation_edits(name, int8_body),
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
        libs[key] = lib
    return libs


def u8_calls(cs, hist, dev, gen, width):
    """{key: (call(variant), B, f, ld, library_ms)} at chip_smoke.py's u8
    shapes."""
    n, f = cs.N_TRAIN, cs.N_FEAT
    bins = torch.randint(0, width, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = cs._rows(gen, n, dev)
    k, BR, fl, nc = (cs.LEAVES_SHAPE[x] for x in ("k", "BR", "f", "NC"))
    comb, lg, lh, lm, block_leaf, _, _ = cs._leaves_inputs(gen, dev)
    if width < 256:                        # bins as a width-B matrix has
        comb = comb % width
    lib_full = cs._full_yardstick(dev, bins, g, h, m, width)
    return {
        "onehot_full/featmajor": (lambda v: hist.hist_onehot_full(
            bins, g, h, m, width, variant=v, layout="featmajor"), width, f,
            f, lib_full),
        "onehot_full/rowmajor": (lambda v: hist.hist_onehot_full(
            bins, g, h, m, width, variant=v, layout="rowmajor"), width, f, f,
            lib_full),
        "onehot_leaves/rowmajor": (lambda v: hist.hist_onehot_leaves(
            comb, lg, lh, lm, block_leaf, k, width, block_rows=BR,
            f_limit=fl, variant=v), width, fl, nc, cs._leaves_yardstick(
                dev, comb, lg, lh, lm, block_leaf, k, width, BR, fl)),
    }


def u16_calls(cs, hist, dev, gen, width, bundle):
    """{key: (call(variant), B, f, ld, library_ms)} at the u16 shapes (see
    the top)."""
    n, f = cs.N_TRAIN, cs.N_FEAT
    g, h, m = cs._rows(gen, n, dev)
    calls = {}
    for case, bins in (("random", cs._u16(gen, (n, f), width + 60, dev)),
                       ("zipf", cs._zipf_u16(gen, (n, f), width, dev))):
        lib = cs._full_yardstick(dev, bins, g, h, m, width)
        for layout in (("featmajor", "rowmajor") if case == "random"
                       else ("featmajor",)):
            calls[f"onehot_full/{layout}/{case}"] = (
                lambda v, bins=bins, layout=layout: hist.hist_onehot_full(
                    bins, g, h, m, width, variant=v, layout=layout),
                width, f, f, lib)
    k, BR, C = (cs.LEAVES_SHAPE[x] for x in ("k", "BR", "C"))
    _, lg, lh, lm, block_leaf, _, _ = cs._leaves_inputs(gen, dev)
    for case, bins in (("random", cs._u16(gen, (C, f), width + 60, dev)),
                       ("zipf", cs._zipf_u16(gen, (C, f), width, dev))):
        comb = cs._frontier_comb(bins, lg, lh, lm)
        calls[f"onehot_leaves/rowmajor/{case}"] = (
            lambda v, comb=comb: hist.hist_onehot_leaves(
                comb, lg, lh, lm, block_leaf, k, width, block_rows=BR,
                f_limit=f, variant=v), width, f, comb.shape[1],
            cs._leaves_yardstick(dev, comb, lg, lh, lm, block_leaf, k, width,
                                 BR, f))
    if bundle:
        data = cs.breadth_data()
        bins, Bb = data["bins"], int(data["bundle_bins"])
        nc = bins.shape[1]
        bg, bh, bm = cs._rows(gen, bins.shape[0], dev)
        calls["onehot_full/featmajor/bundle"] = (
            lambda v: hist.hist_onehot_full(bins, bg, bh, bm, Bb, variant=v),
            Bb, nc, nc, cs._full_yardstick(dev, bins, bg, bh, bm, Bb))
    return calls


def _hold(row, key, got, again, ref):
    """The error of a call against the plain version, its NaNs, and the
    same bits from a second call."""
    fin = torch.isfinite(ref)
    row[f"{key}/relerr"] = float(((got[fin] - ref[fin]).abs()
                                  / (ref[fin].abs() + 1)).max())
    row[f"{key}/nan_equal"] = bool(torch.equal(torch.isnan(got),
                                               torch.isnan(ref)))
    row[f"{key}/same_bits_twice"] = bool(torch.equal(got[fin], again[fin]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--copies", default=",".join(ABLATIONS),
                    help="the copies to build and time")
    ap.add_argument("--bodies", default=None,
                    help="the one-hot bodies to time")
    ap.add_argument("--width", type=int, default=B,
                    help="the bin width B (above 256: u16 bins)")
    ap.add_argument("--bundle", action="store_true",
                    help="at u16, also the sparse_efb bundle matrix")
    ap.add_argument("--int8-body", default="words", choices=INT8_BODIES,
                    help="the int8 body the sources hold (for its edits)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time int8 with its register bound sized "
                         "for 2, 3 and 4 CTAs an SM")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "onehot_ablation.json"))
    args = ap.parse_args()
    names = tuple(args.copies.split(",")) + (tuple(SWEEP) if args.sweep
                                             else ())
    bad = [n for n in names if n not in ABLATIONS and n not in SWEEP]
    if bad:
        print(f"torch_onehot_ablation: unknown copies {bad}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_onehot_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import histogram as hist
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_all(_build, names, args.int8_body)
    width = args.width
    bodies = tuple((args.bodies or ",".join(
        U16_BODIES if width > 256 else BODIES)).split(","))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    calls = (u16_calls(cs, hist, dev, gen, width, args.bundle)
             if width > 256 else u8_calls(cs, hist, dev, gen, width))
    designs = getattr(hist, "ONEHOT_DESIGNS", ())
    rows = []
    saved = dict(_build._LIBS)
    try:
        for name in names:
            row = {"ablation": name, "card": smi, "B": width,
                   "int8_body": args.int8_body}
            for kern in KERNELS:
                _build._LIBS[kern] = libs[name, kern]
            for key, (fn, Bc, f, ld, library_ms) in calls.items():
                kern, layout = key.split("/")[:2]
                for v in bodies:
                    if name in SWEEP and v != "int8":
                        continue
                    k = f"{key}/{v}"
                    match = (f"{kern}_",)          # one kernel a call
                    row[f"{k}/kernel_ms"] = cs.calls_ms(lambda: fn(v),
                                                        match)
                    if name == "repo" or name in SWEEP:
                        row[f"{k}/ms"] = cs.median_ms(lambda: fn(v))
                    a = hist.onehot_kernel_attributes(kern, v, f, Bc, layout,
                                                      ld=ld)
                    row[f"{k}/registers"] = a["registers"]
                    row[f"{k}/local_bytes"] = a["local_bytes"]
                    if name != "repo":
                        continue
                    row[f"{k}/library_ms"] = library_ms
                    with hist.force_plain():
                        ref = fn(v)
                    got, again = fn(v), fn(v)
                    torch.cuda.synchronize()
                    _hold(row, k, got, again, ref)
                    del ref, got, again
                    if "design" in a:
                        row[f"{k}/design"] = a["design"]
                        for other in designs:
                            if other == a["design"] or (
                                    other == "bucketed" and Bc <= 256):
                                continue
                            with hist.onehot_design(other):
                                row[f"{k}/{other}_kernel_ms"] = cs.calls_ms(
                                    lambda: fn(v), match)
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        _build._LIBS.clear()
        _build._LIBS.update(saved)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
