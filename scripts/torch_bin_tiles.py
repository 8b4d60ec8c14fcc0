"""The PyTorch port's atomic histogram kernels at bin-tiled widths, on one
NVIDIA card.

    python3 scripts/torch_bin_tiles.py [--widths 12000,16384,65536]
        [--kinds random,zipf] [--reps 2] [--out PATH]
    python3 scripts/torch_bin_tiles.py --untiled [--out PATH]
    python3 scripts/torch_bin_tiles.py --filled [--out PATH]

Where one feature's ``[B, 3]`` float64 histogram does not fit a CTA,
``hist_full`` and ``hist_leaves`` take the listed design
(``ops/kernels/hist_common.cuh``, ``hist_lists.cu``): a pre-pass lists
each (slot, feature, tile of 256 bins)'s rows, and each warp walks only
its unit of one list.  This script times both kernels at
``chip_smoke.py``'s shapes (the full pass at 1M x 28, one frontier round's
comb of 28 u16 features and 6 gh columns, C=262,144, k=16, BR=512,
slot-ordered) with random and Zipf-skewed bins (``chip_smoke._wide_u16``)
at each width, ``--reps`` times, in the plan's design.  For each: the
plan (tile width, tiles, CTAs, the pre-pass's row blocks, entries a
unit), the float64 partials' and the lists' bytes, the time of a call (median of 20, CUDA events), the kernels
alone (torch.profiler, mean of 10 calls) and of those the pre-pass's apart,
whether the result is bit for bit the plain version's and the same bits
twice, and ``index_add_``'s time on the same inputs.  The pre-pass kernel
is also held bit for bit against its plain version (``bin_lists_plain``).

``--untiled`` times instead the shapes one tile holds, which the listed
design must leave as they were: K1 and K2 at u8 (B = 256, the main path)
and u16 at B = 1,024, kernel alone and call.  To compare with an older
checkout in one call, untar it under ``chip_tmp/``, copy this script into
its ``scripts/`` and run it there too (parent, change, change, parent);
the script asks the wrappers only for what that checkout has.  The
earlier walked design of bin tiles (bin tiles along ``gridDim.y``, every
tile walking every row) is timed only by a checkout that still has it,
with that checkout's own copy of this script.

``--filled`` times each kernel at B = 65,536 (random bins) on a card
filled by a tensor held here, so that a third of the call's one-pass
buffer stays free beside its output: its first call, which meets the
failed allocations and halves its feature passes until they fit
(``histogram.halve_passes``), on the host clock with the card
synchronized around it; its later calls, which take the passes it kept
(median of 20, CUDA events); and the one-pass call before the fill; each
result bit for bit the one-pass result.

Prints the card's name and power limit, one JSON line per case, and
writes them all to ``chiprun_out/bin_tiles.json`` (or ``--out``).  Exits
non-zero without a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _calls(hist, kernel, inputs, width):
    """(call, plain, index_add_ yardstick, units, stride, f, k) of one
    kernel on its inputs."""
    if kernel == "hist_full":
        bins, g, h, m = inputs

        def call():
            return hist.hist_full(bins, g, h, m, width)

        def plain():
            return hist.hist_full_plain(bins, g, h, m, width)

        def lib(dev):
            return cs._full_yardstick(dev, bins, g, h, m, width)
        return call, plain, lib, bins.shape[0], bins.shape[1], \
            bins.shape[1], 1
    comb, g, h, m, bl = inputs
    f, k, BR = cs.N_FEAT, cs.LEAVES_SHAPE["k"], cs.LEAVES_SHAPE["BR"]
    kw = dict(block_rows=BR, f_limit=f)

    def call():
        return hist.hist_leaves(comb, g, h, m, bl, k, width, **kw)

    def plain():
        return hist.hist_leaves_plain(comb, g, h, m, bl, k, width, **kw)

    def lib(dev):
        return cs._leaves_yardstick(dev, comb, g, h, m, bl, k, width, BR, f)
    return call, plain, lib, comb.shape[0] // BR, comb.shape[1], f, k


def _time(hist, kernel, dev, width, inputs, ref):
    """One kernel in the plan's design: plan, scratch, times, exactness."""
    call, _, _, units, stride, f, k = _calls(hist, kernel, inputs, width)
    plan = hist.atomic_plan(kernel, dev, stride, f, width, esz=2)
    got, again = call(), call()
    torch.cuda.synchronize()
    row = {"kernel": kernel, "width": width,
           "design": hist.ATOMIC_DESIGNS[plan["design"]],
           "tile_bins": plan["tile_bins"], "tiles": plan["tiles"],
           "registers": plan["registers"],
           "local_bytes": plan["local_bytes"],
           "ctas_per_sm": plan["ctas_per_sm"],
           "bit_identical": bool(torch.equal(got.view(torch.int32),
                                             ref.view(torch.int32))),
           "same_bits_twice": bool(torch.equal(
               got.view(torch.int32), again.view(torch.int32))),
           "relerr": cs.relerr(got, ref),
           "ms": cs.median_ms(call),
           "kernel_ms": cs.calls_ms(call, cs.ATOMIC_KERNELS[kernel])}
    if hasattr(hist, "atomic_scratch"):
        row.update(hist.atomic_scratch(
            kernel, plan, f, width, units, k,
            cs.LEAVES_SHAPE["BR"]))
    else:
        grid_x, per, partials = hist.atomic_partials(kernel, plan,
                                                     units, k)
        row.update(partial_bytes=partials * f * width * 24,
                   list_bytes=0, ctas=grid_x * plan["groups"]
                   * plan["tiles"], row_chunks=grid_x, unit=per)
    if plan["design"] == 2:
        row["prepass_ms"] = cs.calls_ms(call, cs.LISTS_KERNELS)
        row["by_kernel_ms"] = _by_kernel(call)
    return row


def _by_kernel(call, reps=10):
    """Device ms a call of each kernel a call launches (torch.profiler)."""
    return {e.key[:60]: cs._device_us(e) / 1e3 / reps
            for e in cs._device_rows(call, reps, ("hist_",))
            if "hist_" in e.key}


def _lists_check(hist, kernel, inputs, width, plan_geo):
    """The pre-pass alone on these inputs: bit for bit its plain version,
    its call time, and one library sort of the same keys."""
    if kernel == "hist_full":
        mat, g, h, m = inputs
        kw = dict(block_rows=plan_geo["list_rows"])
        f = mat.shape[1]
    else:
        mat, g, h, m, bl = inputs
        kw = dict(block_rows=cs.LEAVES_SHAPE["BR"], block_leaf=bl,
                  num_slots=cs.LEAVES_SHAPE["k"])
        f = cs.N_FEAT
    kw.update(f_limit=f, tile_bins=plan_geo["tile_bins"],
              unit=hist.list_unit(plan_geo, f * mat.shape[0]))

    def call():
        return hist.bin_lists(mat, g, h, m, width, **kw)
    got = call()
    ref = hist.bin_lists_plain(mat, g, h, m, width, **kw)
    keys = (hist.widen_bins(mat[:, :f]) >> 8).int().t().contiguous()
    return {"lists_bit_identical": hist.lists_equal(got, ref),
            "lists_entries": int(got.seg_len.sum()),
            "lists_ms": cs.median_ms(call),
            "lists_kernel_ms": cs.calls_ms(call, cs.LISTS_KERNELS),
            "sort_ms": cs.median_ms(lambda: torch.sort(keys, dim=1,
                                                       stable=True))}


def _inputs(gen, dev, width, kind):
    n, f = cs.N_TRAIN, cs.N_FEAT
    C, k, BR = (cs.LEAVES_SHAPE[x] for x in ("C", "k", "BR"))
    full = (cs._wide_u16(gen, (n, f), width, dev, kind),
            *cs._rows(gen, n, dev))
    bl = torch.sort(torch.randint(0, k, (C // BR,), generator=gen,
                                  device=dev)).values.to(torch.int32)
    leaves = (cs._frontier_comb(cs._wide_u16(gen, (C, f), width, dev, kind),
                                *cs._rows(gen, C, dev)),
              *cs._rows(gen, C, dev), bl)
    return {"hist_full": full, "hist_leaves": leaves}


def tiled(hist, dev, args):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for width in (int(w) for w in args.widths.split(",")):
        for kind in args.kinds.split(","):
            data = _inputs(gen, dev, width, kind)
            for kernel, inputs in data.items():
                call, plain, lib, *_ = _calls(hist, kernel, inputs, width)
                ref = plain()
                runs = [_time(hist, kernel, dev, width, inputs, ref)
                        for _ in range(args.reps)]
                stride = _calls(hist, kernel, inputs, width)[4]
                geo = hist.atomic_plan(kernel, dev, stride, cs.N_FEAT, width,
                                       esz=2)
                row = {"kernel": kernel, "width": width, "kind": kind,
                       "index_add_ms": lib(dev), "runs": runs,
                       **_lists_check(hist, kernel, inputs, width, geo)}
                rows.append(row)
                print(json.dumps(row), flush=True)
            del data
            torch.cuda.empty_cache()
    return rows


def untiled(hist, dev, args):
    """K1 and K2 at the shapes one tile holds: u8 B = 256 and u16 B =
    1,024, kernel alone and call, on chip_smoke.py's inputs."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, f = cs.N_TRAIN, cs.N_FEAT
    C, k, BR = (cs.LEAVES_SHAPE[x] for x in ("C", "k", "BR"))
    rows = []
    for B, dtype in ((256, torch.uint8), (1024, torch.uint16)):
        if dtype == torch.uint8:
            bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                                 dtype=torch.uint8)
            comb = torch.randint(0, 256, (C, f + 12), generator=gen,
                                 device=dev, dtype=torch.uint8)
        else:
            bins = cs._u16(gen, (n, f), B + 60, dev)
            comb = cs._frontier_comb(cs._u16(gen, (C, f), B + 60, dev),
                                     *cs._rows(gen, C, dev))
        g, h, m = cs._rows(gen, n, dev)
        lg, lh, lm = cs._rows(gen, C, dev)
        bl = torch.sort(torch.randint(0, k, (C // BR,), generator=gen,
                                      device=dev)).values.to(torch.int32)
        cases = {"hist_full": lambda: hist.hist_full(bins, g, h, m, B),
                 "hist_leaves": lambda: hist.hist_leaves(
                     comb, lg, lh, lm, bl, k, B, block_rows=BR, f_limit=f)}
        for kernel, call in cases.items():
            row = {"kernel": kernel, "width": B, "dtype": str(dtype),
                   "ms": cs.median_ms(call),
                   "kernel_ms": cs.calls_ms(call, cs.ATOMIC_KERNELS[kernel])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def filled(hist, dev, args):
    """K1 and K2 at B = 65,536 with a third of their one-pass buffer free
    beside the output (see the top)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    width = 65_536
    rows = []
    for kernel, inputs in _inputs(gen, dev, width, "random").items():
        call, _, _, _, stride, f, k = _calls(hist, kernel, inputs, width)
        n = inputs[0].shape[0]
        plan = hist.atomic_plan(kernel, dev, stride, f, width, esz=2)
        cr = (plan["list_rows"] if kernel == "hist_full"
              else hist.list_chunk_rows(cs.LEAVES_SHAPE["BR"]))
        one = hist.list_pass_bytes(plan, f, n, k, cr)
        one_ms = cs.median_ms(call)
        ref = call()
        out_bytes = ref.numel() * ref.element_size()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(dev)[0]
        fill = torch.empty(free - out_bytes - one // 3, dtype=torch.uint8,
                           device=dev)
        hist._list_passes_taken.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = call()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        first_same = bool(torch.equal(got.view(torch.int32),
                                      ref.view(torch.int32)))
        del got
        passes = [p for p in hist._list_passes_taken.values()]
        later_ms = cs.median_ms(call)
        again = call()
        row = {"kernel": kernel, "width": width, "one_pass_bytes": one,
               "free_beside_output": one // 3, "filled_bytes": fill.numel(),
               "passes": passes[0] if passes else [(0, f)],
               "one_pass_ms": one_ms, "first_call_host_ms": first_ms,
               "later_ms": later_ms, "first_bit_identical": first_same,
               "later_bit_identical": bool(torch.equal(
                   again.view(torch.int32), ref.view(torch.int32)))}
        del fill, again, ref
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="12000,16384,65536")
    ap.add_argument("--kinds", default="random,zipf")
    ap.add_argument("--reps", type=int, default=2,
                    help="runs a case")
    ap.add_argument("--untiled", action="store_true",
                    help="time the shapes one tile holds instead")
    ap.add_argument("--filled", action="store_true",
                    help="time B = 65,536 on a card too full for one pass")
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
    rows = (untiled if args.untiled else filled if args.filled
            else tiled)(hist, dev, args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
