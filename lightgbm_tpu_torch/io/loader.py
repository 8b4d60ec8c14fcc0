"""Text data loading: CSV / TSV / LibSVM with auto-detection.

The port's copy of the JAX package's ``io/loader.py`` (analog of the
reference parser stack, ``src/io/parser.cpp`` CreateParser auto-detection,
``TextReader``): the native parser (``native/``) reads the file, numpy when
it is unavailable.  Label column by index or ``name:<col>``, and the
``weight_column``/``group_column``/``ignore_column`` roles, as in the
reference.  A file whose binned footprint will exceed the out-of-core
budget is announced at load time, as in the JAX package (the binding
decision is ``Dataset.stream_plan()``'s, after binning).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..config import Config
from ..utils.log import Log, check


def _detect_format(first_lines: List[str]) -> str:
    """Auto-detect csv/tsv/libsvm (reference Parser::GuessDataFormat)."""
    for line in first_lines:
        if not line.strip():
            continue
        tokens = line.strip().split()
        if any(":" in t for t in tokens[1:]):
            return "libsvm"
        if "\t" in line:
            return "tsv"
        if "," in line:
            return "csv"
    return "csv"


def detect_file_format(path: str) -> str:
    """csv/tsv/libsvm sniff of a data file's head (shared with
    Booster.predict's file path)."""
    with open(path) as f:
        head = [f.readline() for _ in range(3)]
    return _detect_format(head)


def load_file(path: str, config: Optional[Config] = None):
    """Load a data file -> (features, label, feature_names, weight,
    group_sizes); the last two come from ``weight_column``/``group_column``
    (None otherwise)."""
    cfg = config or Config()
    check(os.path.exists(path), f"data file {path} does not exist")
    fmt = detect_file_format(path)
    if fmt == "libsvm":
        feat, label, names = _load_libsvm(path)
        out = (feat, label, names, None, None)
    else:
        out = _load_delimited(path, "\t" if fmt == "tsv" else ",", cfg)
    _announce_stream_budget(out[0], cfg, path)
    return out


def _announce_stream_budget(feat, cfg: Config, path: str) -> None:
    """Out-of-core heads-up at file-load time: the u8-bin estimate (one
    byte a cell, exact whenever max_bin <= 256) tells command-line users
    at ingest that this file will train from host RAM."""
    from ..stream.host_matrix import effective_budget_bytes
    budget = effective_budget_bytes(cfg)
    if not budget or feat is None:
        return
    projected = int(np.prod(feat.shape))
    if projected > budget:
        Log.info(
            "%s: projected binned footprint ~%.1f MB exceeds the %.1f MB "
            "device budget; training will stream row blocks from host RAM",
            path, projected / 1e6, budget / 1e6)


def _load_delimited(path: str, delim: str, cfg: Config):
    header = cfg.header
    names: Optional[List[str]] = None
    skip = 0
    if header:
        with open(path) as f:
            names = f.readline().strip().split(delim)
        skip = 1
    # native parallel parser (parser.cpp ParseDelimited); numpy fallback
    from ..native import parse_delimited
    data = parse_delimited(path, delim, skip)
    if data is None:
        data = np.genfromtxt(path, delimiter=delim, skip_header=skip,
                             dtype=np.float64)
    if data.ndim == 1:
        data = data.reshape(-1, 1)
    # label column (default first; 'name:<x>' or index via label_column)
    label_idx = 0
    lc = cfg.label_column
    if lc:
        if str(lc).startswith("name:"):
            check(names is not None, "label by name requires header=true")
            label_idx = names.index(str(lc)[5:])
        else:
            label_idx = int(lc)
    label = data[:, label_idx].astype(np.float32)
    feat = np.delete(data, label_idx, axis=1)
    if names:
        names = [n for i, n in enumerate(names) if i != label_idx]

    # weight / group / ignore columns (reference DatasetLoader::SetHeader,
    # src/io/dataset_loader.cpp -- numeric indices DON'T count the label
    # column, so they resolve against the label-less matrix)
    def resolve(spec: str) -> List[int]:
        out = []
        for item in str(spec).split(","):
            item = item.strip()
            if not item:
                continue
            by_name = item.startswith("name:")
            if by_name:
                item = item[5:]
            # bare digits are ALWAYS indices (reference semantics) -- a
            # header column literally named '4' must use the name: prefix
            if not by_name and item.isdigit():
                out.append(int(item))
            elif names is not None and item in names:
                out.append(names.index(item))
            else:
                check(item.isdigit(),
                      f"column '{item}' not found (name-based columns "
                      "require header=true; numeric indices must be "
                      ">= 0 and not count the label column)")
                out.append(int(item))
        return out

    weight = group = None
    drop: List[int] = []
    if cfg.weight_column:
        widx, = resolve(cfg.weight_column)
        weight = feat[:, widx].astype(np.float32)
        drop.append(widx)
    if cfg.group_column:
        gidx, = resolve(cfg.group_column)
        qid = feat[:, gidx]
        # per-row query ids -> group sizes over consecutive runs
        change = np.nonzero(np.diff(qid) != 0)[0] + 1
        bounds = np.concatenate([[0], change, [len(qid)]])
        group = np.diff(bounds).astype(np.int64)
        drop.append(gidx)
    if cfg.ignore_column:
        drop.extend(resolve(cfg.ignore_column))
    if drop:
        keep = [i for i in range(feat.shape[1]) if i not in set(drop)]
        feat = feat[:, keep]
        if names:
            names = [names[i] for i in keep]
    return feat, label, names, weight, group


def _load_libsvm(path: str):
    from ..native import parse_libsvm
    native = parse_libsvm(path)
    if native is not None:
        feat, labels = native
        return feat, labels.astype(np.float32), None
    labels = []
    rows = []
    max_feat = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            row = {}
            for tok in parts[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":", 1)
                idx = int(k)
                row[idx] = float(v)
                max_feat = max(max_feat, idx)
            rows.append(row)
    n = len(rows)
    feat = np.zeros((n, max_feat + 1), dtype=np.float64)
    for i, row in enumerate(rows):
        for k, v in row.items():
            feat[i, k] = v
    return feat, np.asarray(labels, np.float32), None
