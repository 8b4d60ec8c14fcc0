"""Native (C++) ingest runtime: parallel text parsing and binning on the host.

The port's copy of the JAX package's ``native/__init__.py``: ``parser.cpp``
(a copy of the JAX package's) is built with ``g++`` on first use into
``native/_build/`` under a name keyed on a hash of the source and the flags,
and loaded with ctypes.  Every entry point returns None when the library is
unavailable and the caller (``io/loader.py``, ``io/dataset.py``) takes its
numpy version, which gives the same values (the tests hold the two equal);
the first such fallback logs a warning.  ``native_calls`` counts the calls
that the library served.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.log import Log

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "parser.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False
_warned = False
# calls served by the library, by entry point
native_calls: Dict[str, int] = {"parse_delimited": 0, "parse_libsvm": 0,
                                "bin_values": 0}


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"_parser-{digest.hexdigest()[:16]}.so")


def _build(so: str) -> bool:
    """Compile into a temporary name and rename it into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception as e:          # no g++, a compile error, a timeout
        Log.warning("native parser build failed (%s)", e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None when it cannot be built."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            Log.warning("native parser failed to load (%s)", e)
            _build_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.SetParserSectionBytes.argtypes = [ctypes.c_int64]
        lib.SetParserSectionBytes.restype = None
        lib.CountDelimited.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                       ctypes.c_int, i64p, i64p]
        lib.ParseDelimited.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                       ctypes.c_int, ctypes.c_int64,
                                       ctypes.c_int64, f64p]
        lib.CountLibSVM.argtypes = [ctypes.c_char_p, i64p, i64p]
        lib.ParseLibSVM.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, f64p, f64p]
        lib.BinValues.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                  f64p, i64p, i32p, i32p, u8p, i32p, u16p]
        for fn in ("CountDelimited", "ParseDelimited", "CountLibSVM",
                   "ParseLibSVM", "BinValues"):
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
        return _lib


def _lib_or_warn() -> Optional[ctypes.CDLL]:
    global _warned
    lib = get_lib()
    if lib is None and not _warned:
        _warned = True
        Log.warning("native parser unavailable: parsing and binning take "
                    "the numpy path")
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_delimited(path: str, delim: str, skip_rows: int = 0
                    ) -> Optional[np.ndarray]:
    """CSV/TSV -> dense [rows, cols] float64, or None if native unavailable."""
    lib = _lib_or_warn()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    pb = path.encode()
    if lib.CountDelimited(pb, delim.encode(), skip_rows,
                          ctypes.byref(rows), ctypes.byref(cols)):
        return None
    out = np.empty((rows.value, cols.value), np.float64)
    if lib.ParseDelimited(pb, delim.encode(), skip_rows, rows.value,
                          cols.value, _ptr(out, ctypes.c_double)):
        return None
    native_calls["parse_delimited"] += 1
    return out


def parse_libsvm(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """LibSVM -> (features [rows, cols], labels [rows]) or None."""
    lib = _lib_or_warn()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    pb = path.encode()
    if lib.CountLibSVM(pb, ctypes.byref(rows), ctypes.byref(cols)):
        return None
    out = np.zeros((rows.value, cols.value), np.float64)
    labels = np.empty(rows.value, np.float64)
    if lib.ParseLibSVM(pb, rows.value, cols.value,
                       _ptr(out, ctypes.c_double), _ptr(labels, ctypes.c_double)):
        return None
    native_calls["parse_libsvm"] += 1
    return out, labels


def bin_values(data: np.ndarray, mappers, used_features) -> Optional[np.ndarray]:
    """Raw [n, F_total] float64 -> binned [n, F_used] uint16 using the
    per-feature BinMappers; None if native unavailable.  Semantics match
    ``BinMapper.value_to_bin`` exactly (tests enforce equality)."""
    lib = _lib_or_warn()
    if lib is None:
        return None
    from ..io.bin import BinType, MissingType
    cols = len(used_features)
    n = data.shape[0]
    uppers, offsets, nan_bins, default_bins, is_cat, cat_perm = \
        [], [0], [], [], [], []
    for f in used_features:
        m = mappers[f]
        if m.bin_type == BinType.CATEGORICAL:
            cats = np.asarray(m.bin_2_categorical, np.float64)
            order = np.argsort(cats)
            uppers.append(cats[order])
            cat_perm.append(order.astype(np.int32) + 1)
            nan_bins.append(-1)
            default_bins.append(0)
            is_cat.append(1)
        else:
            ub = np.asarray(m.bin_upper_bound, np.float64)
            uppers.append(ub)
            cat_perm.append(np.zeros(len(ub), np.int32))
            nan_bins.append(m.num_bin - 1
                            if m.missing_type == MissingType.NAN else -1)
            default_bins.append(int(np.searchsorted(ub, 0.0, side="left"))
                                if len(ub) else 0)
            is_cat.append(0)
        offsets.append(offsets[-1] + len(uppers[-1]))
    uppers_c = (np.concatenate(uppers) if uppers else np.zeros(0)).astype(np.float64)
    cat_perm_c = (np.concatenate(cat_perm) if cat_perm else
                  np.zeros(0, np.int32)).astype(np.int32)
    offsets_c = np.asarray(offsets, np.int64)
    nan_c = np.asarray(nan_bins, np.int32)
    def_c = np.asarray(default_bins, np.int32)
    cat_c = np.asarray(is_cat, np.uint8)

    sub = np.ascontiguousarray(data[:, list(used_features)], np.float64)
    out = np.empty((n, cols), np.uint16)
    if lib.BinValues(_ptr(sub, ctypes.c_double), n, cols,
                     _ptr(uppers_c, ctypes.c_double),
                     _ptr(offsets_c, ctypes.c_int64),
                     _ptr(nan_c, ctypes.c_int32), _ptr(def_c, ctypes.c_int32),
                     _ptr(cat_c, ctypes.c_uint8),
                     _ptr(cat_perm_c, ctypes.c_int32),
                     _ptr(out, ctypes.c_uint16)):
        return None
    native_calls["bin_values"] += 1
    return out


__all__ = ["get_lib", "parse_delimited", "parse_libsvm", "bin_values",
           "native_calls", "library_path"]
