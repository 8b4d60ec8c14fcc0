"""Where the time of the PyTorch port's bf16-pair one-hot kernels goes, on
one NVIDIA card.

    python3 scripts/torch_onehot_ablation.py

Builds ``onehot_full`` and ``onehot_leaves`` (``lightgbm_tpu_torch/ops/
kernels``) from the sources as they are and from copies with one part of
the work taken out, and times each body's kernel alone at
``chip_smoke.py``'s shapes: the full pass (featmajor, 1M x 28) and one
frontier round's leaves (C=262,144, NC=40, f=28, k=16, BR=512), B=256,
for ``base``, ``bf16cmp`` and ``staged``.  A copy edits
``onehot_common.cuh`` as text (each edit must match exactly once, or the
script stops) and is built with the port's ``nvcc`` flags into
``ops/_build/ablation/<name>/``; what a copy computes is wrong on purpose,
only its time is read.

  repo        the sources as they are
  const_a     each tile's A fragment is a constant: no bin word read and
              no one-hot built; staging, split, mma and fold stay
  no_mma      each bf16 mma.sync becomes an XOR of its six operands into
              its first sum: the one-hot build stays live, the tensor
              cores do nothing
  skeleton    const_a and no_mma together: staging, split, loop and fold

The float64 fold cannot be taken out alone: with its sums unused, ptxas
deletes the mma instructions as dead code (the asm's volatile does not
reach it) and the build with them, so such a copy times almost nothing.  The skeleton bounds it.

Kernel time: torch.profiler's device time per launch (mean of 10 calls),
as ``chip_smoke.py``'s ``kernel_ms``; registers a thread from the
kernels' attribute query.  Prints one JSON line per copy and writes them
all to ``chiprun_out/onehot_ablation.json``.  Exits non-zero without a
CUDA card.
"""
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

# (old, new) text edits of onehot_common.cuh, each matching exactly once
_CONST_A = [
    ("  const Step<V> s(*reinterpret_cast<const uint32_t*>(bp), ids);\n",
     ""),
    ("    s.tile(tl, a);\n",
     "    a[0] = a[1] = a[2] = a[3] = kOneLo * (uint32_t)(tl + 1);\n"),
]
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
ABLATIONS = {"repo": [], "const_a": _CONST_A, "no_mma": _NO_MMA,
             "skeleton": _CONST_A + _NO_MMA}
KERNELS = ("onehot_full", "onehot_leaves")
BODIES = ("base", "bf16cmp", "staged")
B = 256


def _patched_sources(name, edits, kernel_dir, out_dir):
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    shutil.copytree(kernel_dir, out_dir)
    path = os.path.join(out_dir, "onehot_common.cuh")
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit matches {text.count(old)} "
                               f"times, not once: {old[:60]!r}")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)


def build_all(_build):
    """{(ablation, kernel): ctypes library}, one nvcc each, all at once."""
    import ctypes
    root = _build.BUILD_DIR / "ablation"
    procs = {}
    for name, edits in ABLATIONS.items():
        src = root / name
        _patched_sources(name, edits, str(_build.KERNEL_DIR), str(src))
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


def main() -> int:
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
    libs = build_all(_build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n, f = cs.N_TRAIN, cs.N_FEAT
    bins = torch.randint(0, B, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    g, h, m = cs._rows(gen, n, dev)
    k, BR, fl = (cs.LEAVES_SHAPE[x] for x in ("k", "BR", "f"))
    comb, lg, lh, lm, block_leaf, _, _ = cs._leaves_inputs(gen, dev)
    calls = {
        "onehot_full": lambda v: hist.hist_onehot_full(
            bins, g, h, m, B, variant=v, layout="featmajor"),
        "onehot_leaves": lambda v: hist.hist_onehot_leaves(
            comb, lg, lh, lm, block_leaf, k, B, block_rows=BR, f_limit=fl,
            variant=v),
    }
    rows = []
    saved = dict(_build._LIBS)
    try:
        for name in ABLATIONS:
            row = {"ablation": name, "card": smi, "B": B}
            for kern in KERNELS:
                _build._LIBS[kern] = libs[name, kern]
                for v in BODIES:
                    fn = calls[kern]
                    row[f"{kern}/{v}/kernel_ms"] = cs.kernel_ms(
                        lambda: fn(v), kern + "_kernel")
                    row[f"{kern}/{v}/registers"] = \
                        hist.onehot_kernel_attributes(
                            kern, v, f if kern == "onehot_full" else fl, B,
                            "featmajor" if kern == "onehot_full"
                            else "rowmajor",
                            ld=cs.LEAVES_SHAPE["NC"])["registers"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        _build._LIBS.clear()
        _build._LIBS.update(saved)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "onehot_ablation.json"),
              "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
