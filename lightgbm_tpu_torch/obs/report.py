"""Perf-trajectory report: render the results journal + a metrics snapshot.

``python -m lightgbm_tpu_torch obs-report`` (and a supervisor, after each
run) reads ``perf_results.jsonl`` — schema events and legacy
pre-schema lines alike — and renders a markdown or JSON report: record
counts by kind, the headline bench summaries over time, watcher windows,
and the process's live metrics snapshot when one exists.

Legacy tolerance is the point: the journal predates the schema by many
runs, so the loader classifies every line via ``events.classify_record``
instead of assuming the envelope, and nothing here throws on old shapes.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from . import costs as _costs
from . import regress as _regress
from .events import classify_record, perf_log_path

__all__ = ["load_perf_log", "summarize", "render_markdown", "render_json",
           "roofline_rows", "render_roofline", "render_regressions",
           "render_health", "main"]


def load_perf_log(path: Optional[str] = None) -> Dict[str, Any]:
    """Read + classify every line; missing file -> empty load (a fresh
    checkout has no journal yet and the report must still render)."""
    path = path or perf_log_path()
    events: List[Dict[str, Any]] = []
    legacy: List[Dict[str, Any]] = []
    bad = 0
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        lines = []
    for line in lines:
        if not line.strip():
            continue
        kind, rec = classify_record(line)
        if kind == "event":
            events.append(rec)
        elif kind == "legacy":
            legacy.append(rec)
        else:
            bad += 1
    return {"path": path, "events": events, "legacy": legacy, "bad": bad,
            "total": len(events) + len(legacy) + bad}


def _stage_of(rec: Dict[str, Any]) -> str:
    return str(rec.get("event") or rec.get("stage") or rec.get("bench")
               or rec.get("metric") or "<unkeyed>")


def _is_summary(rec: Dict[str, Any]) -> bool:
    return (rec.get("event") == "bench_summary"
            or ("metric" in rec and "value" in rec)
            or "bench" in rec)


def summarize(loaded: Dict[str, Any],
              metrics_snapshot: Optional[Dict[str, Any]] = None,
              last_n: int = 12,
              tracer_info: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Aggregate the classified journal into the report's data model."""
    records = loaded["legacy"] + loaded["events"]
    by_stage: Dict[str, int] = {}
    ts_min = ts_max = None
    for rec in records:
        by_stage[_stage_of(rec)] = by_stage.get(_stage_of(rec), 0) + 1
        ts = rec.get("ts")
        if isinstance(ts, (int, float)) and not isinstance(ts, bool):
            ts_min = ts if ts_min is None else min(ts_min, ts)
            ts_max = ts if ts_max is None else max(ts_max, ts)
    summaries = [r for r in records if _is_summary(r)]
    windows = [r for r in records
               if _stage_of(r).startswith("watcher_window")]
    run_ids = sorted({r["run_id"] for r in loaded["events"]})
    return {
        "path": loaded["path"],
        "counts": {"total": loaded["total"],
                   "schema_events": len(loaded["events"]),
                   "legacy": len(loaded["legacy"]),
                   "bad": loaded["bad"]},
        "runs": len(run_ids),
        "ts_range": [ts_min, ts_max],
        "by_stage": dict(sorted(by_stage.items(),
                                key=lambda kv: (-kv[1], kv[0]))),
        "recent_summaries": summaries[-last_n:],
        "windows": windows[-last_n:],
        "metrics": metrics_snapshot or {},
        "tracer": tracer_info or {},
    }


def _fmt_summary_row(rec: Dict[str, Any]) -> str:
    metric = rec.get("metric") or rec.get("bench") or rec.get("event")
    value = rec.get("value")
    unit = rec.get("unit", "")
    backend = rec.get("backend", "")
    val = "" if value is None else (f"{value:g}" if isinstance(
        value, (int, float)) and not isinstance(value, bool) else str(value))
    return f"| {metric} | {val} | {unit} | {backend} |"


def render_markdown(summary: Dict[str, Any]) -> str:
    c = summary["counts"]
    lines = ["# Perf trajectory report", "",
             f"Journal: `{summary['path']}`", "",
             f"- records: **{c['total']}** "
             f"({c['schema_events']} schema event(s), "
             f"{c['legacy']} legacy line(s), {c['bad']} unparseable)",
             f"- distinct runs (schema): {summary['runs']}"]
    ts = summary["ts_range"]
    if ts[0] is not None:
        lines.append(f"- wall-clock span: {ts[1] - ts[0]:.0f} s")
    tr = summary.get("tracer") or {}
    if tr:
        # the ring drops silently when full — the report is where that
        # data loss must become visible
        line = (f"- tracer: {tr.get('spans', 0)} span(s) recorded, "
                f"{tr.get('open_spans', 0)} open")
        if tr.get("dropped"):
            line += (f", **{tr['dropped']} dropped** "
                     f"(ring capacity {tr.get('capacity', '?')})")
        lines.append(line)
    lines += ["", "## Records by kind", "",
              "| kind | count |", "|---|---|"]
    for stage, n in summary["by_stage"].items():
        lines.append(f"| {stage} | {n} |")
    if summary["recent_summaries"]:
        lines += ["", "## Recent bench summaries", "",
                  "| metric | value | unit | backend |", "|---|---|---|---|"]
        for rec in summary["recent_summaries"]:
            lines.append(_fmt_summary_row(rec))
    if summary["windows"]:
        lines += ["", "## Watcher windows", ""]
        for rec in summary["windows"]:
            wid = rec.get("window_id", "?")
            lines.append(f"- window `{wid}`: "
                         + ", ".join(f"{k}={v}" for k, v in rec.items()
                                     if k not in ("stage", "event", "ts",
                                                  "mono", "run_id",
                                                  "schema_version",
                                                  "window_id")))
    if summary["metrics"]:
        lines += ["", "## Telemetry snapshot", "",
                  "| metric | value |", "|---|---|"]
        for name, snap in summary["metrics"].items():
            if snap.get("type") == "histogram" and snap.get("count"):
                val = (f"n={snap['count']} mean={snap['mean']:.4g} "
                       f"p50={snap['p50']:.4g} p99={snap['p99']:.4g}")
            else:
                val = f"{snap.get('value', 0):g}"
            lines.append(f"| {name} | {val} |")
    lines.append("")
    return "\n".join(lines)


def render_json(summary: Dict[str, Any]) -> str:
    return json.dumps(summary, indent=2, default=str)


# --------------------------------------------------------------------------
# --roofline: device-truth cost/MFU rows (obs.costs program_cost events)
# --------------------------------------------------------------------------

def roofline_rows(loaded: Dict[str, Any],
                  ledger: Optional[Any] = None) -> List[Dict[str, Any]]:
    """``program_cost`` records from the journal, plus the live in-process
    ledger's rooflines when one is passed (dedup: live rows win on name)."""
    rows = [r for r in loaded["events"] + loaded["legacy"]
            if r.get("event") == _costs.COST_EVENT
            or r.get("stage") == _costs.COST_EVENT]
    if ledger is not None:
        live = {r["program"]: r for r in ledger.rooflines()}
        rows = [r for r in rows if r.get("program") not in live]
        rows += list(live.values())
    return rows


def _num(v: Any, scale: float = 1.0, fmt: str = "{:.3g}") -> str:
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return fmt.format(v * scale)
    return "" if v is None else str(v)


def render_roofline(rows: List[Dict[str, Any]]) -> str:
    lines = ["## Roofline / MFU (XLA cost ledger)", ""]
    if not rows:
        lines += ["_no program_cost records (run a bench with the cost "
                  "ledger enabled, or emit a CostLedger)._", ""]
        return "\n".join(lines)
    lines += ["| program | chip | calls | ms/call | GFLOP/s | MFU | "
              "model MFU | GB/s | AI (F/B) | bound |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append("| {} | {} | {} | {} | {} | {} | {} | {} | {} | {} |"
                     .format(r.get("program", "?"), r.get("chip", "?"),
                             r.get("calls", ""),
                             _num(r.get("seconds_per_call"), 1e3),
                             _num(r.get("achieved_flops_per_sec"), 1e-9),
                             _num(r.get("mfu"), fmt="{:.4f}"),
                             _num(r.get("model_mfu"),
                                  fmt="{:.4f}") or
                             _num(r.get("predicted_mfu"), fmt="{:.4f}"),
                             _num(r.get("achieved_bytes_per_sec"), 1e-9),
                             _num(r.get("intensity")),
                             r.get("bound", "")))
    lines.append("")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# --regressions: sentinel verdicts over journal + BENCH_r* history
# --------------------------------------------------------------------------

def render_regressions(result: Dict[str, Any], gate: bool = False) -> str:
    counts = result["counts"]
    lines = ["## Perf-regression sentinel", "",
             "- verdicts: " + (", ".join(f"{k}: **{v}**" for k, v in
                                         sorted(counts.items())) or "none"),
             f"- gate: {'**REGRESSED**' if result['regressed'] else 'clean'}"
             + (" (exit nonzero)" if gate and result["regressed"] else ""),
             ""]
    shown = [v for v in result["verdicts"] if v["verdict"] != "no-baseline"]
    hidden = len(result["verdicts"]) - len(shown)
    if shown:
        lines += ["| metric | field | backend | shape | verdict | "
                  "baseline | latest | Δ% | n |",
                  "|---|---|---|---|---|---|---|---|---|"]
        for v in shown:
            verdict = v["verdict"] + (f" ({v['severity']})"
                                      if v.get("severity") else "")
            lines.append("| {} | {} | {} | {} | {} | {} | {} | {} | {} |"
                         .format(v["metric"], v["field"], v["backend"],
                                 v["shape"] or "-", verdict,
                                 _num(v.get("baseline_median")),
                                 _num(v.get("latest")),
                                 _num(v.get("rel_change"), 100.0,
                                      "{:+.1f}"),
                                 v["n_baseline"]))
    if hidden:
        lines.append(f"\n_{hidden} series below the "
                     f"{_regress.MIN_BASELINE}-sample baseline floor "
                     "(no-baseline)._")
    lines.append("")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# --health: runtime health plane (live /healthz or in-process snapshot)
# --------------------------------------------------------------------------

def _health_data(url: Optional[str] = None) -> Dict[str, Any]:
    """The health payload: fetched from a live process's ``/healthz`` when
    ``--health-url`` is given, else this process's own snapshot (useful
    right after an in-process run, or for the flight/tracer state)."""
    if url:
        import urllib.request
        if "://" not in url:
            url = "http://" + url
        if not url.rstrip("/").endswith("/healthz"):
            url = url.rstrip("/") + "/healthz"
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read().decode())
    from . import health as _health
    return _health.health_snapshot()


def render_health(data: Dict[str, Any]) -> str:
    lines = ["## Runtime health", "",
             f"- ok: {'**yes**' if data.get('ok') else '**NO**'}"
             f" (pid {data.get('pid', '?')}, "
             f"uptime {_num(data.get('uptime_s'))} s)"]
    if data.get("error"):
        lines.append(f"- fetch error: {data['error']} "
                     f"(url: {data.get('url')})")
        lines.append("")
        return "\n".join(lines)
    for key in ("run_id", "stage", "iteration"):
        if data.get(key) is not None:
            lines.append(f"- {key}: `{data[key]}`")
    if data.get("last_event_ts") is not None:
        lines.append(f"- last event ts: {_num(data['last_event_ts'])}")
    tr = data.get("tracer") or {}
    if tr:
        lines.append(f"- tracer: {tr.get('spans', 0)} span(s), "
                     f"{tr.get('open_spans', 0)} open, "
                     f"{tr.get('dropped', 0)} dropped")
    fl = data.get("flight") or {}
    if fl:
        lines.append(f"- flight recorder: {fl.get('events', 0)} event(s) "
                     f"in ring, {fl.get('dumps', 0)} dump(s) -> "
                     f"`{fl.get('path', '?')}`")
    status = data.get("status") or {}
    numeric = {k: v for k, v in status.items()
               if k.startswith(("numeric", "last_numeric"))}
    if numeric:
        lines.append("- numeric sentinels: "
                     + ", ".join(f"{k}={v}"
                                 for k, v in sorted(numeric.items())))
    dm = data.get("device_memory") or {}
    if dm:
        lines += ["", "### Device memory watermarks", "",
                  "| gauge | bytes |", "|---|---|"]
        for name, v in dm.items():
            lines.append(f"| {name} | {_num(v)} |")
    slos = data.get("slo") or []
    if slos:
        lines += ["", "### Serve SLO burn rates", "",
                  "| model | window | requests | error_rate | p99_ms | "
                  "error burn | latency burn | breached |",
                  "|---|---|---|---|---|---|---|---|"]
        for rep in slos:
            for wname, w in (rep.get("windows") or {}).items():
                lines.append(
                    "| {} | {} | {} | {} | {} | {} | {} | {} |".format(
                        rep.get("model", "?"), wname,
                        w.get("requests", 0), _num(w.get("error_rate")),
                        _num(w.get("p99_ms")), _num(w.get("error_burn")),
                        _num(w.get("latency_burn")),
                        "**yes**" if w.get("breached") else "no"))
    else:
        lines.append("- serve SLO: no objectives registered "
                     "(`serve_slo_p99_ms` / `serve_slo_error_rate`)")
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch obs-report",
        description="render the perf journal + telemetry snapshot")
    ap.add_argument("--path", default=None,
                    help="journal to read (default: WATCHER_PERF_LOG or "
                         "repo perf_results.jsonl)")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    ap.add_argument("--out", default=None,
                    help="write here instead of stdout")
    ap.add_argument("--no-metrics", action="store_true",
                    help="omit the in-process metrics snapshot")
    ap.add_argument("--roofline", action="store_true",
                    help="render only the cost-ledger roofline/MFU rows")
    ap.add_argument("--regressions", action="store_true",
                    help="render only the perf-regression sentinel verdicts")
    ap.add_argument("--health", action="store_true",
                    help="render only the runtime-health section (status "
                         "board, sentinels, SLO burn rates, flight state)")
    ap.add_argument("--health-url", default=None, metavar="HOST:PORT",
                    help="with --health: fetch /healthz from a live "
                         "process instead of this process's snapshot")
    ap.add_argument("--gate", action="store_true",
                    help="with --regressions: exit nonzero on any "
                         "regressed verdict")
    ap.add_argument("--bench-glob", default=None,
                    help="history round files for the sentinel "
                         "(default: BENCH_r*.json beside the journal)")
    args = ap.parse_args(argv)

    rc = 0
    loaded = load_perf_log(args.path)
    if args.roofline or args.regressions or args.health:
        # focused sections (CLI/gate mode): no base report around them
        parts = []
        payload: Dict[str, Any] = {}
        if args.roofline:
            rows = roofline_rows(loaded, ledger=_costs.get_ledger())
            parts.append(render_roofline(rows))
            payload["roofline"] = rows
        if args.regressions:
            res = _regress.scan(journal_path=loaded["path"],
                                bench_glob=args.bench_glob)
            parts.append(render_regressions(res, gate=args.gate))
            payload["regressions"] = res
            if args.gate and res["regressed"]:
                rc = 1
        if args.health:
            try:
                hdata = _health_data(args.health_url)
            except OSError as e:
                hdata = {"ok": False, "error": str(e),
                         "url": args.health_url}
            parts.append(render_health(hdata))
            payload["health"] = hdata
        text = ("\n".join(parts) if args.format == "md"
                else json.dumps(payload, indent=2, default=str))
    else:
        snap = None
        if not args.no_metrics:
            from .metrics import snapshot as _snapshot
            snap = _snapshot()
        tracer_info = None
        try:
            from .tracer import get_tracer
            t = get_tracer()
            if t.spans() or t.dropped or t.open_spans():
                tracer_info = {"spans": len(t.spans()),
                               "open_spans": len(t.open_spans()),
                               "dropped": t.dropped,
                               "capacity": t.capacity}
        except Exception:
            pass
        data = summarize(loaded, metrics_snapshot=snap,
                         tracer_info=tracer_info)
        text = (render_markdown(data) if args.format == "md"
                else render_json(data))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
