"""Build and load the hand-written Hopper kernels.

Each ``kernels/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (``<name>_launch``, and for
``onehot_full`` also the shootout shell's ``onehot_bench_launch``), loaded
with ``ctypes``.  The one-hot libraries also export an attribute query
(``onehot_full_query``, ``onehot_leaves_query``: registers, static and
dynamic shared memory, spills and CTAs an SM of a body's kernel), the
quantize kernel its registers, spills and geometry at a block size
(``onehot_quant_query``), and the atomic ones a launch plan
(``hist_full_plan``, ``hist_leaves_plan``: the geometry of a launch and
the same attributes of its kernel).
Libraries are cached in ``ops/_build/`` under a name keyed on a hash of the
sources and flags, so an edit to a kernel rebuilds it and an unchanged
kernel is built once per checkout.  ``build()`` starts one ``nvcc`` per
source, all at once, and waits for them.

Nothing here runs at import time: the CPU test suite imports every module of
the package, and this machine may have no ``nvcc``.  A failed build raises
``KernelBuildError``; no caller falls back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNEL_DIR = Path(__file__).resolve().parent / "kernels"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = {"hist_full": "hist_full.cu", "hist_leaves": "hist_leaves.cu",
           "onehot_full": "onehot_full.cu",
           "onehot_leaves": "onehot_leaves.cu",
           "onehot_quant": "onehot_quant.cu"}
# headers each kernel includes: they feed its library's name, so an edit to
# one rebuilds every kernel that includes it
_HEADERS = {"hist_full": ("hist_common.cuh",),
            "hist_leaves": ("hist_common.cuh",),
            "onehot_full": ("onehot_common.cuh",),
            "onehot_leaves": ("onehot_common.cuh",),
            "onehot_quant": ()}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INT_P = ctypes.POINTER(ctypes.c_int)
# argument types of each library's entry points
_ARGTYPES = {
    "hist_full": {
        # device, stride, f, B, esz, design, out[11]
        "hist_full_plan": [_INT, _LL, _INT, _INT, _INT, _INT, _INT_P],
        # device, bins, n, stride, f, B, esz, g, h, m, partial, out, fg,
        # tile, threads, design, grid_x, rows_per_cta, stream
        "hist_full_launch": [_INT, _VOID_P, _LL, _LL, _INT, _INT, _INT,
                             _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
                             _INT, _INT, _INT, _INT, _INT, _LL, _VOID_P]},
    "hist_leaves": {
        # device, stride, f, B, esz, design, out[11]
        "hist_leaves_plan": [_INT, _LL, _INT, _INT, _INT, _INT, _INT_P],
        # device, comb, c, stride, f, B, esz, g, h, m, block_leaf, br, k,
        # scratch, out, fg, tile, threads, design, grid_x, bpc, parts,
        # stream
        "hist_leaves_launch": [_INT, _VOID_P, _LL, _LL, _INT, _INT, _INT,
                               _VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT,
                               _INT, _VOID_P, _VOID_P, _INT, _INT, _INT,
                               _INT, _INT, _INT, _INT, _VOID_P]},
    "onehot_full": {
        # device, bins, ld, n, f, layout, esz, g, h, m, q, scales, qbr,
        # out, variant, lpf, lanes, nf_max, stream
        "onehot_full_launch": [_INT, _VOID_P, _LL, _LL, _INT, _INT, _INT,
                               _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
                               _INT, _VOID_P, _INT, _INT, _INT, _INT,
                               _VOID_P],
        # device, bins_t, n, f, esz, rows (or q), scales, qbr, out,
        # variant, lpf, lanes, nf_max, stream
        "onehot_bench_launch": [_INT, _VOID_P, _LL, _INT, _INT, _VOID_P,
                                _VOID_P, _INT, _VOID_P, _INT, _INT, _INT,
                                _INT, _VOID_P],
        # variant, layout, nf_max, ld, esz, out[5]
        "onehot_full_query": [_INT, _INT, _INT, _LL, _INT, _INT_P]},
    "onehot_leaves": {
        # device, comb, ld, c, f, esz, g, h, m, q, scales, block_leaf, br,
        # k, out, variant, lpf, lanes, nf_max, stream
        "onehot_leaves_launch": [_INT, _VOID_P, _LL, _LL, _INT, _INT,
                                 _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
                                 _VOID_P, _INT, _INT, _VOID_P, _INT, _INT,
                                 _INT, _INT, _VOID_P],
        # variant, nf_max, ld, esz, out[5]
        "onehot_leaves_query": [_INT, _INT, _LL, _INT, _INT_P]},
    "onehot_quant": {
        # device, x0, x1, x2, prep, n, br, q, s, stream
        "onehot_quant_launch": [_INT, _VOID_P, _VOID_P, _VOID_P, _INT, _LL,
                                _INT, _VOID_P, _VOID_P, _VOID_P],
        # br, out[5]
        "onehot_quant_query": [_INT, _INT_P]},
}

# loaded libraries, one per kernel for the life of the process
_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel failed to compile or to load."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (KERNELS[name],) + _HEADERS[name]:
        h.update((KERNEL_DIR / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` each, all in parallel.  Returns seconds per kernel built (0.0
    when the cached library was reused); ``ptxas`` register and
    shared-memory usage goes to ``<lib>.log`` beside each library."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        out = lib_path(n)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(KERNEL_DIR / KERNELS[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """The nvcc/ptxas output of the kernel's last build ('' if reused)."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = lib_path(name)
    if not path.exists():
        build([name])
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for entry, argtypes in _ARGTYPES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lgbt_error_string.argtypes = [ctypes.c_int]
    lib.lgbt_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib
