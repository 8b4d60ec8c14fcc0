"""Perf-regression sentinel: self-judge every new number against history.

VERDICT weak #2: "hardware regression risk is unbounded" — a TPU window
landing slower than round 1 would burn silently.  This module closes
that: it builds robust per-(metric, backend, shape) baselines from the
accumulated history (``perf_results.jsonl`` schema + legacy lines, plus
the committed ``BENCH_r*.json`` round files) and classifies the latest
sample of every series as improved / ok / regressed / no-baseline with a
severity, so ``python -m lightgbm_tpu_torch obs-report --regressions [--gate]``
(and the watcher's post-stage verdict records, and the perf suite's
closing ``regress`` phase) flag a slowdown loudly while the window is
still open.

Robustness choices:

- baseline = median, spread = MAD (scaled by 1.4826 to a normal-sigma
  equivalent) with a relative floor — one wedged outlier round (e.g.
  BENCH_r03's 2.0 s/tree next to 0.81/0.82) must not poison the center
  OR make the band so wide everything passes;
- min-sample floor: fewer than :data:`MIN_BASELINE` prior samples in a
  series -> ``no-baseline`` (never ``regressed``), so fresh metrics and
  renamed series (the honest-labeling fix) cannot false-positive;
- a verdict needs BOTH a robust-z excursion and a relative change above
  :data:`REL_THRESHOLD` — MAD can be ~0 on repeated identical values and
  a pure z-test would then flag noise.

Series keys: ``(metric, backend, shape)`` where shape collects the
fields that change the workload (rows, max_bin, variant, br,
num_leaves).  Metric names are canonicalized — size/backend-suffix
tokens (``_1m``, ``_200k``, ``_cpu_fallback``) are stripped because the
backend and rows already live in the key — so the corrected
``higgs_200k_cpu_fallback_train_throughput`` label continues the series
the mislabeled ``higgs_1m_train_throughput`` cpu/200k lines started.

Deliberately stdlib-only (the port's copy of the JAX package's
``obs/regress.py``): a supervisor judges a possibly-wedged run from
outside without loading torch.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["MIN_BASELINE", "REL_THRESHOLD", "FIELD_DIRECTION",
           "canonical_metric", "extract_samples", "load_history",
           "classify", "scan", "VERDICT_EVENT"]

#: event name for emitted verdict records
VERDICT_EVENT = "regression_verdict"

#: a series needs this many PRIOR samples before its latest is judged
MIN_BASELINE = 3

#: relative change below this is never a verdict (noise floor)
REL_THRESHOLD = 0.15

#: robust-z (MAD-sigma) excursion required alongside the relative change
Z_THRESHOLD = 3.0

#: numeric fields worth judging, and which direction is better.  Only
#: fields listed here become series — free-form stage records carry too
#: much incidental timing (compile secs, probe secs) to judge raw.
FIELD_DIRECTION: Dict[str, str] = {
    "sec_per_tree": "lower", "ms": "lower", "ms_per_tree": "lower",
    "hist_kernel_ms": "lower", "p50_ms": "lower", "p99_ms": "lower",
    "predict_ms": "lower",
    "value": "higher",          # flipped to lower for ms/sec-unit summaries
    "vs_baseline": "higher", "mfu": "higher", "grows_per_sec": "higher",
    "rows_per_sec": "higher", "auc": "higher",
}

#: fields that define the workload shape (part of the series key)
SHAPE_FIELDS = ("rows", "max_bin", "variant", "br", "num_leaves", "name")

#: stage/event kinds whose records are judged even without the summary
#: shape (known perf-bearing micro-bench records)
STAGE_PREFIXES = ("hist_pallas", "hist_onehot", "hist_leaves",
                  "onehot_variant", "grow_", "headline_bench",
                  "bench_serve", "bench_stream")

_SIZE_TOKEN = re.compile(r"_(\d+(?:p\d+)?[km]?)(?=_|$)", re.IGNORECASE)


def canonical_metric(name: str) -> str:
    """Strip size / fallback tokens so renamed series keep their history
    (backend + rows live in the key, not the name)."""
    out = _SIZE_TOKEN.sub("", str(name))
    out = out.replace("_cpu_fallback", "").replace("_fallback", "")
    return out.strip("_") or str(name)


# --------------------------------------------------------------------------
# sample extraction
# --------------------------------------------------------------------------

def _flatten(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Merge one level of the known nesting envelopes (``detail`` on bench
    summaries, ``result`` on watcher/suite stage records, ``parsed`` on
    BENCH round files) over the top-level fields."""
    out = dict(rec)
    for key in ("parsed", "result", "detail"):
        inner = out.pop(key, None)
        if isinstance(inner, dict):
            nested = inner.pop("detail", None)
            out.update(inner)
            if isinstance(nested, dict):
                out.update(nested)
    return out


def _base_name(rec: Dict[str, Any], flat: Dict[str, Any]) -> Optional[str]:
    if isinstance(flat.get("metric"), str):
        return canonical_metric(flat["metric"])
    for k in ("bench", "event", "stage"):
        v = rec.get(k) or flat.get(k)
        if isinstance(v, str) and v:
            if k in ("event", "stage") and not v.startswith(STAGE_PREFIXES):
                return None
            return v
    return None


def _direction(field: str, flat: Dict[str, Any]) -> str:
    d = FIELD_DIRECTION[field]
    if field == "value":
        unit = str(flat.get("unit", "")).lower()
        if "ms" in unit or unit in ("s", "sec", "secs", "seconds"):
            return "lower"
    return d


def extract_samples(rec: Dict[str, Any], seq: int = 0) -> List[Dict[str, Any]]:
    """Judgeable samples in one journal/bench record.  Each sample:
    ``{key, metric, backend, shape, field, value, direction, seq}`` where
    ``key`` is the hashable series identity."""
    if not isinstance(rec, dict):
        return []
    flat = _flatten(rec)
    # failed/aborted records carry no trustworthy numbers
    if flat.get("error") or flat.get("ok") is False or flat.get("skipped"):
        return []
    base = _base_name(rec, flat)
    if not base:
        return []
    backend = str(flat.get("backend", "") or "unknown").lower()
    shape = ",".join(f"{k}={flat[k]}" for k in SHAPE_FIELDS
                     if flat.get(k) is not None)
    out = []
    for field in FIELD_DIRECTION:
        v = flat.get(field)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        out.append({"key": (base, backend, shape, field), "metric": base,
                    "backend": backend, "shape": shape, "field": field,
                    "value": float(v),
                    "direction": _direction(field, flat), "seq": seq})
    return out


def load_history(journal_path: Optional[str] = None,
                 bench_glob: Optional[str] = None) -> List[Dict[str, Any]]:
    """All samples from the round files + journal, in chronological order
    (BENCH_r* sorted by name first — they predate the journal's schema
    era — then journal lines in file order)."""
    from .events import perf_log_path
    journal_path = journal_path or perf_log_path()
    if bench_glob is None:
        bench_glob = os.path.join(
            os.path.dirname(os.path.abspath(journal_path)), "BENCH_r*.json")
    samples: List[Dict[str, Any]] = []
    seq = 0
    for path in sorted(_glob.glob(bench_glob)):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(rec, dict) or rec.get("rc") not in (0, None):
            continue
        if isinstance(rec.get("parsed"), dict):
            samples.extend(extract_samples(rec, seq))
            seq += 1
    try:
        with open(journal_path) as f:
            lines = f.readlines()
    except OSError:
        lines = []
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            samples.extend(extract_samples(rec, seq))
            seq += 1
    return samples


# --------------------------------------------------------------------------
# classification
# --------------------------------------------------------------------------

def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def classify(baseline: List[float], latest: float, direction: str,
             min_baseline: int = MIN_BASELINE,
             rel_threshold: float = REL_THRESHOLD) -> Dict[str, Any]:
    """Verdict for ``latest`` against the prior samples of its series."""
    n = len(baseline)
    if n < min_baseline:
        return {"verdict": "no-baseline", "n_baseline": n}
    med = _median(baseline)
    mad = _median([abs(v - med) for v in baseline])
    scale = max(1.4826 * mad, 0.05 * abs(med), 1e-12)
    z = (latest - med) / scale
    rel = (latest - med) / abs(med) if med else 0.0
    # positive worse_* = the metric moved the WRONG way
    sign = 1.0 if direction == "lower" else -1.0
    worse_z, worse_rel = sign * z, sign * rel
    out = {"verdict": "ok", "n_baseline": n, "baseline_median": med,
           "baseline_mad": mad, "latest": latest, "z": round(z, 3),
           "rel_change": round(rel, 4), "direction": direction}
    if worse_z > Z_THRESHOLD and worse_rel > rel_threshold:
        out["verdict"] = "regressed"
        out["severity"] = ("critical" if worse_rel > 1.0 else
                           "major" if worse_rel > 0.5 else "minor")
    elif worse_z < -Z_THRESHOLD and worse_rel < -rel_threshold:
        out["verdict"] = "improved"
    return out


def scan(journal_path: Optional[str] = None,
         bench_glob: Optional[str] = None,
         samples: Optional[Iterable[Dict[str, Any]]] = None,
         min_baseline: int = MIN_BASELINE) -> Dict[str, Any]:
    """Judge the LATEST sample of every series against the rest.

    Returns ``{"verdicts": [...], "counts": {...}, "regressed": bool}``;
    verdicts are sorted worst-first (regressed > no-baseline > ok >
    improved, then by |rel_change|)."""
    if samples is None:
        samples = load_history(journal_path, bench_glob)
    series: Dict[Tuple, List[Dict[str, Any]]] = {}
    for s in samples:
        series.setdefault(s["key"], []).append(s)
    verdicts = []
    for key, ss in series.items():
        ss.sort(key=lambda s: s["seq"])
        latest = ss[-1]
        v = classify([s["value"] for s in ss[:-1]], latest["value"],
                     latest["direction"], min_baseline=min_baseline)
        v.update(metric=latest["metric"], backend=latest["backend"],
                 shape=latest["shape"], field=latest["field"])
        verdicts.append(v)
    rank = {"regressed": 0, "no-baseline": 1, "ok": 2, "improved": 3}
    verdicts.sort(key=lambda v: (rank[v["verdict"]],
                                 -abs(v.get("rel_change", 0.0)),
                                 v["metric"], v["field"]))
    counts: Dict[str, int] = {}
    for v in verdicts:
        counts[v["verdict"]] = counts.get(v["verdict"], 0) + 1
    return {"verdicts": verdicts, "counts": counts,
            "regressed": counts.get("regressed", 0) > 0}
