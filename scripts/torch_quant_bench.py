"""The int8 variant's pre-pass on one NVIDIA card: what it costs a
histogram call, form by form.

    python3 scripts/torch_quant_bench.py [--reps N] [--out PATH]

The pre-pass turns grad, hess and mask into the int8 one-hot kernels'
operands: ``q [9, N]`` int8 and the scales ``s [nblocks, 9]`` of the three
levels of the rows ``(g·m, h·m, m)``, quantized per block of rows
(``onehot_quant.cu``).  Timed at ``chip_smoke.py``'s three cases of its
quant phase: 1M rows per 1024 (the featmajor full pass), 1M rows per 512
(rowmajor), and one frontier round's 262,144 rows per 512 with a NaN
gradient in block 100 (the leaves), in each input form the checkout has:

  prep_rows   ``quantize_int8_blocks(prep_f32(g, h, m), br)``: the rows
              made by three torch ops, then the kernel (what the int8
              wrappers ran before the quantize kernel read grad, hess and
              mask itself; the shootout shell still quantizes rows that
              its caller prepped)
  fused       ``quantize_int8(g, h, m, br)``, where the checkout has it:
              the kernel forms the products itself

For each: ``ms``, the median of 20 CUDA-event-timed calls, wrapper
included; ``kernel_ms``, the quantize kernel's own device time
(torch.profiler, mean of 10 calls); ``device_ms``, every device row of a
call; ``launches``, the device launches a call, by name; whether the
result is bit-identical to ``quantize_int8_blocks_plain(prep_f32(g, h,
m), br)``; and the byte bound (12 bytes read and 9 written a row, 36 a
block, at 3.35 TB/s).  Then the device launches of one int8 histogram
call, full pass (1M x 28, featmajor) and leaves (C=262,144, NC=40, f=28,
k=16, BR=512), B=256, with their ``ms``.  Registers and spilled bytes of
the quantize kernel from ``ptxas -v``.

``--copies every_x_divided,reciprocal`` also builds copies of
``onehot_quant.cu`` with one part of the design changed and times each
kernel alone in the fused form at the three cases, with whether it still
gives the same bits:

  every_x_divided   a zero x goes through ``__fdiv_rn`` too, as every
                    other x does (the kernel divides it as s / s): the
                    same bits, slower
  reciprocal        x times a float32 reciprocal of s in place of the
                    IEEE division: what the division costs (its bits
                    differ, so only its time is read)

Prints the card's name and power limit, one JSON line per case, and
writes them to ``chiprun_out/quant_bench.json`` (or ``--out``).  To time
an older checkout side by side, copy this script into that checkout's
``scripts/`` and run it from there in the same call.  Exits non-zero
without a CUDA card.
"""
import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

QUANT_KERNEL = "quant_kernel"
# (old, new) text edits of onehot_quant.cu, each matching once
EDITS = {"every_x_divided": [(
    "        const float d = __fdiv_rn(zero ? sc : x, sc);\n"
    "        const float qf = rintf(zero ? __fmul_rn(x, d) : d);\n",
    "        const float qf = rintf(__fdiv_rn(x, sc));\n")],
    "reciprocal": [(
        "      uint32_t w[R / 4] = {};\n",
        "      const float rc = 1.f / sc;\n      uint32_t w[R / 4] = {};\n"), (
        "        const float d = __fdiv_rn(zero ? sc : x, sc);\n",
        "        const float d = __fmul_rn(zero ? sc : x, rc);\n")]}


def patched_source(name, text):
    """``text`` with the copy ``name``'s edits applied, each matching
    once, or the script stops."""
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit matches {text.count(old)} "
                               f"times, not once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_copy(_build, name):
    """The quantize library of the copy ``name``, built with the port's
    nvcc flags into ``ops/_build/ablation/quant/``."""
    import ctypes
    text = (_build.KERNEL_DIR / _build.KERNELS["onehot_quant"]).read_text()
    out = _build.BUILD_DIR / "ablation" / "quant"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(patched_source(name, text))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(out / f"{name}.so"), str(out / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    for entry, argtypes in _build._ARGTYPES["onehot_quant"].items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    lib.lgbt_error_string.argtypes = [ctypes.c_int]
    lib.lgbt_error_string.restype = ctypes.c_char_p
    return lib


def ptxas(log, kernel):
    """{kernel's mangled name: (registers, spilled bytes)} for every entry
    whose name holds ``kernel``, from ``ptxas -v``'s output."""
    out, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            current = m.group(1)
            if kernel in current:
                out[current] = [None, None]
        if current not in out:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            out[current][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[current][0] = int(m.group(1))
    return out


def profile_call(fn, reps):
    """(device launches a call by name, device ms a call) over ``reps``
    calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    names = {}
    for e in rows:
        names[e.key[:90]] = names.get(e.key[:90], 0) + e.count / reps
    return names, sum(cs._device_us(e) for e in rows) / 1e3 / reps


def kernel_ms(call, reps):
    """The quantize kernel's device time a call; a second profiler window
    when the first records no launch of it (seen once, right after a
    copy's library was loaded)."""
    ms = cs.calls_ms(call, (QUANT_KERNEL,), reps)
    return ms if ms is not None else cs.calls_ms(call, (QUANT_KERNEL,), reps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--copies", default="",
                    help=f"copies to time: {', '.join(EDITS)}")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "quant_bench.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_quant_bench: no CUDA device", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import histogram as hist
    from lightgbm_tpu_torch.ops import onehot_variants as ov
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build(["onehot_quant", "onehot_full", "onehot_leaves"])
    regs = ptxas(_build.build_log("onehot_quant"), QUANT_KERNEL)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n, f, B = cs.N_TRAIN, cs.N_FEAT, 256
    g, h, m = cs._rows(gen, n, dev)
    comb, lg, lh, lm, block_leaf, _, _ = cs._leaves_inputs(gen, dev)
    cases = {"featmajor": ((g, h, m), ov.pallas_block_rows(
                 "int8", "featmajor", n, f, B)),
             "rowmajor": ((g, h, m), ov.pallas_block_rows(
                 "int8", "rowmajor", n, f, B)),
             "leaves": ((lg, lh, lm), cs.LEAVES_SHAPE["BR"])}
    forms = {"prep_rows": lambda x, br: hist.quantize_int8_blocks(
        ov.prep_f32(*x), br)}
    if hasattr(hist, "quantize_int8"):
        forms["fused"] = lambda x, br: hist.quantize_int8(*x, br)
    rows = []
    for case, (x, br) in cases.items():
        rn = x[0].shape[0]
        ref = ov.quantize_int8_blocks_plain(ov.prep_f32(*x), br)
        b_ms, b_by = cs.bound(21 * rn + 36 * (-(-rn // br)), 54 * rn)
        for form, fn in forms.items():
            call = (lambda fn=fn, x=x, br=br: fn(x, br))
            got = call()
            torch.cuda.synchronize()
            launches, dev_ms = profile_call(call, args.reps)
            row = {"case": case, "form": form, "rows": rn, "block_rows": br,
                   "card": smi, "bit_identical": cs._same_quant(got, ref),
                   "ms": cs.median_ms(call),
                   "kernel_ms": kernel_ms(call, args.reps),
                   "device_ms": dev_ms,
                   "launches_per_call": sum(launches.values()),
                   "launches": launches, "bound_ms": b_ms,
                   "bound_by": b_by, "ptxas": regs}
            print(json.dumps(row), flush=True)
            rows.append(row)
    for name in filter(None, args.copies.split(",")):
        saved = _build._LIBS["onehot_quant"]
        _build._LIBS["onehot_quant"] = build_copy(_build, name)
        try:
            for case, (x, br) in cases.items():
                call = (lambda x=x, br=br: hist.quantize_int8(*x, br))
                ref = ov.quantize_int8_blocks_plain(ov.prep_f32(*x), br)
                row = {"case": case, "copy": name, "card": smi,
                       "bit_identical": cs._same_quant(call(), ref),
                       "kernel_ms": kernel_ms(call, args.reps)}
                print(json.dumps(row), flush=True)
                rows.append(row)
        finally:
            _build._LIBS["onehot_quant"] = saved
    bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    k, BR = cs.LEAVES_SHAPE["k"], cs.LEAVES_SHAPE["BR"]
    calls = {
        "int8_full": lambda: hist.hist_onehot_full(
            bins, g, h, m, B, variant="int8", layout="featmajor"),
        "int8_leaves": lambda: hist.hist_onehot_leaves(
            comb, lg, lh, lm, block_leaf, k, B, block_rows=BR, f_limit=f,
            variant="int8")}
    for name, call in calls.items():
        launches, dev_ms = profile_call(call, args.reps)
        row = {"case": name, "card": smi, "ms": cs.median_ms(call),
               "device_ms": dev_ms,
               "launches_per_call": sum(launches.values()),
               "launches": launches}
        print(json.dumps(row), flush=True)
        rows.append(row)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
