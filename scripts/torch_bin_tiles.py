"""The PyTorch port's atomic histogram kernels in bin tiles, by tile count,
on one NVIDIA card.

    python3 scripts/torch_bin_tiles.py [--widths 12000,16384,65536]
        [--tiles 0,16,32,64] [--out PATH]

Where one feature's ``[B, 3]`` float64 histogram does not fit a CTA, the
plan of ``hist_full`` and ``hist_leaves`` splits each feature's bins into
bin tiles along ``gridDim.y`` (``ops/kernels/hist_common.cuh``): the
fewest tiles that fit, one feature a CTA.  This script times both kernels
at ``chip_smoke.py``'s shapes (the full pass at 1M x 28, one frontier
round's comb of 28 u16 features and 6 gh columns, C=262,144, k=16,
BR=512, slot-ordered) with random bins (``chip_smoke._wide_u16``) at
each width, under the plan's own tiles (``0``) and under more tiles asked
through ``histogram.atomic_tiles`` (narrower tiles, so a CTA holds more
features, each with its own ticket chain, at the same staged bytes a
row).  For each: the plan (feature group, tiles, bins a tile, CTAs),
the kernel-alone time (torch.profiler, the main and reduce kernels, mean
of 10 calls), the time of a call (median of 20, CUDA events), and whether
the result is bit for bit the plain version's.  Prints the card's name and
power limit, one line per case, and writes them all to
``chiprun_out/bin_tiles.json`` (or ``--out``).  Exits non-zero without a
CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _case(hist, kernel, dev, width, tiles, inputs):
    """One kernel at one width and tile count: plan, times, exactness."""
    if kernel == "hist_full":
        bins, g, h, m = inputs
        stride, units, f = bins.shape[1], bins.shape[0], bins.shape[1]

        def call():
            return hist.hist_full(bins, g, h, m, width)

        def plain():
            return hist.hist_full_plain(bins, g, h, m, width)
    else:
        comb, g, h, m, bl = inputs
        stride, f = comb.shape[1], cs.N_FEAT
        units = comb.shape[0] // cs.LEAVES_SHAPE["BR"]
        kw = dict(block_rows=cs.LEAVES_SHAPE["BR"], f_limit=f)
        k = cs.LEAVES_SHAPE["k"]

        def call():
            return hist.hist_leaves(comb, g, h, m, bl, k, width, **kw)

        def plain():
            return hist.hist_leaves_plain(comb, g, h, m, bl, k, width, **kw)
    ref = plain()
    with hist.atomic_tiles(max(1, tiles)):
        plan = hist.atomic_plan(kernel, dev, stride, f, width, esz=2)
        grid_x = hist.atomic_partials(kernel, plan, units)[0]
        got = call()
        torch.cuda.synchronize()
        row = {"kernel": kernel, "width": width, "tiles_asked": tiles,
               "fg": plan["fg"], "tiles": plan["tiles"],
               "tile_bins": plan["tile_bins"], "tile_rows": plan["tile"],
               "ctas": grid_x * plan["groups"] * plan["tiles"],
               "bit_identical": bool(torch.equal(got.view(torch.int32),
                                                 ref.view(torch.int32))),
               "kernel_ms": cs.calls_ms(call, cs.ATOMIC_KERNELS[kernel]),
               "ms": cs.median_ms(call)}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="12000,16384,65536")
    ap.add_argument("--tiles", default="0,16,32,64",
                    help="bin tiles to ask for (0: the plan's own)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bin_tiles.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bin_tiles: no CUDA device", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops import histogram as hist
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, f = cs.N_TRAIN, cs.N_FEAT
    C, k, BR = (cs.LEAVES_SHAPE[x] for x in ("C", "k", "BR"))
    rows = []
    for width in (int(w) for w in args.widths.split(",")):
        full = (cs._wide_u16(gen, (n, f), width, dev, "random"),
                *cs._rows(gen, n, dev))
        bl = torch.sort(torch.randint(0, k, (C // BR,), generator=gen,
                                      device=dev)).values.to(torch.int32)
        leaves = (cs._frontier_comb(cs._wide_u16(gen, (C, f), width, dev,
                                                 "random"),
                                    *cs._rows(gen, C, dev)),
                  *cs._rows(gen, C, dev), bl)
        for tiles in (int(t) for t in args.tiles.split(",")):
            for kernel, inputs in (("hist_full", full),
                                   ("hist_leaves", leaves)):
                row = _case(hist, kernel, dev, width, tiles, inputs)
                rows.append(row)
                print(json.dumps(row), flush=True)
        del full, leaves
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
