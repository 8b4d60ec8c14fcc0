"""Live health plane: metrics exposition, health status, SLO burn rate.

Everything in ``obs/`` so far is post-hoc — journals and reports read
after the run.  This module makes a live process observable while it is
running:

- :func:`start_health_server` — a daemon-thread ``http.server`` bound to
  127.0.0.1 answering ``GET /metrics`` (Prometheus text exposition
  rendered from the process :class:`~lightgbm_tpu_torch.obs.metrics
  .MetricsRegistry`) and ``GET /healthz`` (the JSON of
  :func:`health_snapshot`).  Enabled by the ``obs_health_port`` config
  knob (or the ``LGBM_OBS_HEALTH_PORT`` env var the watcher exports to
  its stages); auto-started by the boosting loops and
  ``serve.Predictor``.  ``port=0`` binds an ephemeral port (tests).
- :func:`set_status` — a tiny process-wide status board (run_id, stage,
  iteration, last numeric check …) the training loops update per
  iteration; ``/healthz`` reads it.
- :class:`SLOMonitor` — per-model multi-window (default 5 min / 1 h)
  burn rates for p99 latency and error-rate objectives
  (``serve_slo_p99_ms`` / ``serve_slo_error_rate``), fed from the serve
  batcher's request stream.  Burn rate = observed bad fraction divided
  by the objective's error budget (the SRE convention: 1.0 = exactly
  consuming budget, >1 = burning it).
- :class:`DivergenceError` + :func:`numeric_verdict` — the structured
  failure the numeric-health sentinels in ``GBDT``/``StreamGBDT`` raise
  when gradients/hessians/leaf values go NaN/Inf, carrying the stats and
  the flight-dump path.

Deliberately stdlib-only (the port's copy of the JAX package's
``obs/health.py``) — the device-side reductions live in the model layer;
this module only judges their host-side scalars.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as _metrics

__all__ = [
    "DivergenceError", "SLOMonitor", "HealthServer", "numeric_verdict",
    "check_numeric",
    "render_prometheus", "health_snapshot", "set_status", "get_status",
    "start_health_server", "maybe_start", "get_server", "stop_health_server",
    "register_slo", "unregister_slo", "slo_reports",
]

_START_TIME = time.time()


# ----------------------------------------------------------------------
# numeric divergence
# ----------------------------------------------------------------------
class DivergenceError(RuntimeError):
    """Numeric health sentinel tripped: NaN/Inf in gradients, hessians or
    leaf values.  ``detail`` holds the per-array stats
    (``finite_frac`` / ``max_abs``), ``flight_path`` the forensic dump
    written before raising.

    Derives ``RuntimeError`` (not ``LightGBMError``) so the stdlib-only
    obs package stays importable without the main package.
    """

    def __init__(self, message: str, *, iteration: Optional[int] = None,
                 detail: Optional[Dict[str, Any]] = None,
                 flight_path: Optional[str] = None):
        super().__init__(message)
        self.iteration = iteration
        self.detail = detail or {}
        self.flight_path = flight_path


def check_numeric(stats: Dict[str, Dict[str, float]], *,
                  iteration: int, kind: str = "train",
                  log: Any = None) -> bool:
    """Judge sentinel stats, record the verdict, raise on divergence.

    Updates the status board, emits a ``numeric_health`` event (to the
    telemetry ``log`` when given, else into the flight ring so a later
    dump carries it), and on NaN/Inf writes a flight dump and raises
    :class:`DivergenceError` carrying its path.  The caller supplies the
    host-side scalars — this module never touches device arrays."""
    ok, bad = numeric_verdict(stats)
    flat = {f"{name}_{key}": val for name, s in stats.items()
            for key, val in s.items()}
    set_status(last_numeric_check=iteration, numeric_ok=ok)
    from . import flight as _flight
    if log is not None:
        log.emit("numeric_health", iteration=iteration, kind=kind,
                 ok=ok, **flat)
    else:
        rec = _flight.get_recorder()
        if rec is not None:
            rec.note("numeric_health", iteration=iteration, kind=kind,
                     ok=ok, **flat)
    if ok:
        return True
    path = _flight.dump(f"divergence_iter{iteration}")
    raise DivergenceError(
        f"numeric divergence at iteration {iteration}: non-finite values "
        f"in {', '.join(bad)} (see numeric_health event"
        + (f"; flight dump {path}" if path else "") + ")",
        iteration=iteration, detail=stats, flight_path=path)


def numeric_verdict(stats: Dict[str, Dict[str, float]]
                    ) -> Tuple[bool, List[str]]:
    """Judge per-array sentinel stats.  ``stats`` maps an array name
    (``grad``/``hess``/``leaf_value``) to ``{"finite_frac": f,
    "max_abs": m}``.  Returns ``(ok, bad_names)`` — an array is bad when
    any sampled element is non-finite."""
    bad: List[str] = []
    for name, s in stats.items():
        frac = s.get("finite_frac")
        mx = s.get("max_abs")
        if frac is not None and (not math.isfinite(frac) or frac < 1.0):
            bad.append(name)
        elif mx is not None and not math.isfinite(mx):
            bad.append(name)
    return (not bad, bad)


# ----------------------------------------------------------------------
# process status board
# ----------------------------------------------------------------------
_STATUS: Dict[str, Any] = {}
_STATUS_LOCK = threading.Lock()


def set_status(**fields: Any) -> None:
    """Merge fields into the process status board (``/healthz``)."""
    with _STATUS_LOCK:
        _STATUS.update(fields)
        _STATUS["status_ts"] = time.time()


def get_status() -> Dict[str, Any]:
    with _STATUS_LOCK:
        return dict(_STATUS)


def _reset_status() -> None:
    """Test seam."""
    with _STATUS_LOCK:
        _STATUS.clear()


# ----------------------------------------------------------------------
# SLO burn rate
# ----------------------------------------------------------------------
class SLOMonitor:
    """Multi-window burn-rate tracker for one served model.

    Objectives: ``p99_ms`` (latency) and ``error_rate`` (bad-request
    fraction: exceptions + sheds).  For each window the monitor reports
    the observed error rate and p99 over that window plus burn rates:

    - ``error_burn`` = observed bad fraction / ``error_rate`` objective;
    - ``latency_burn`` = observed p99 / ``p99_ms`` objective.

    A window is ``breached`` when either burn is >= 1.  Requests are
    bucketed per ~window/60 for the counting stats; latencies keep a
    bounded per-window deque (p99 over the last <= 4096 samples).
    ``clock`` is injectable for tests.
    """

    MAX_LATENCIES = 4096

    def __init__(self, name: str, *, p99_ms: Optional[float] = None,
                 error_rate: Optional[float] = None,
                 windows: Tuple[float, ...] = (300.0, 3600.0),
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.p99_ms = float(p99_ms) if p99_ms else None
        self.error_rate = float(error_rate) if error_rate else None
        self.windows = tuple(float(w) for w in windows)
        self._clock = clock
        self._lock = threading.Lock()
        # (bucket_start, requests, bad) buckets, finest granularity
        self._bucket_s = max(1.0, min(self.windows) / 60.0)
        horizon = max(self.windows)
        self._buckets: deque = deque(
            maxlen=int(horizon / self._bucket_s) + 2)
        # (t, latency_ms) samples, bounded
        self._latencies: deque = deque(maxlen=self.MAX_LATENCIES)

    @property
    def enabled(self) -> bool:
        return self.p99_ms is not None or self.error_rate is not None

    # ------------------------------------------------------------------
    def observe(self, latency_ms: Optional[float] = None,
                bad: bool = False) -> None:
        """Record one request outcome (a shed or an exception is
        ``bad=True`` with no latency)."""
        now = self._clock()
        with self._lock:
            start = math.floor(now / self._bucket_s) * self._bucket_s
            if self._buckets and self._buckets[-1][0] == start:
                b = self._buckets[-1]
                self._buckets[-1] = (b[0], b[1] + 1, b[2] + (1 if bad else 0))
            else:
                self._buckets.append((start, 1, 1 if bad else 0))
            if latency_ms is not None:
                self._latencies.append((now, float(latency_ms)))

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        now = self._clock()
        with self._lock:
            buckets = list(self._buckets)
            lats = list(self._latencies)
        out: Dict[str, Any] = {
            "model": self.name,
            "objectives": {"p99_ms": self.p99_ms,
                           "error_rate": self.error_rate},
            "windows": {},
        }
        breached = False
        for w in self.windows:
            cutoff = now - w
            req = sum(b[1] for b in buckets if b[0] + self._bucket_s > cutoff)
            bad = sum(b[2] for b in buckets if b[0] + self._bucket_s > cutoff)
            wl = sorted(l for t, l in lats if t > cutoff)
            p99 = wl[max(0, math.ceil(0.99 * len(wl)) - 1)] if wl else None
            err = (bad / req) if req else 0.0
            win: Dict[str, Any] = {
                "requests": req, "bad": bad,
                "error_rate": round(err, 6),
                "p99_ms": round(p99, 3) if p99 is not None else None,
            }
            wb = False
            if self.error_rate:
                win["error_burn"] = round(err / self.error_rate, 3)
                wb = wb or win["error_burn"] >= 1.0 and bad > 0
            if self.p99_ms and p99 is not None:
                win["latency_burn"] = round(p99 / self.p99_ms, 3)
                wb = wb or win["latency_burn"] >= 1.0
            win["breached"] = wb
            breached = breached or wb
            out["windows"][f"{int(w)}s"] = win
        out["breached"] = breached
        return out


_SLOS: Dict[str, SLOMonitor] = {}
_SLOS_LOCK = threading.Lock()


def register_slo(monitor: SLOMonitor) -> SLOMonitor:
    """Expose a monitor in ``/healthz``/``/metrics`` (keyed by model)."""
    with _SLOS_LOCK:
        _SLOS[monitor.name] = monitor
    return monitor


def unregister_slo(name: str) -> None:
    with _SLOS_LOCK:
        _SLOS.pop(name, None)


def slo_reports() -> List[Dict[str, Any]]:
    with _SLOS_LOCK:
        monitors = list(_SLOS.values())
    return [m.report() for m in monitors]


# ----------------------------------------------------------------------
# prometheus text exposition
# ----------------------------------------------------------------------
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, prefix: str) -> str:
    n = prefix + _NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def render_prometheus(snapshot: Optional[Dict[str, Dict[str, Any]]] = None,
                      *, prefix: str = "lgbtpu_") -> str:
    """Prometheus text exposition (0.0.4) of a registry snapshot:
    counters and gauges natively, histograms as summaries with
    ``quantile`` labels from the reservoir percentiles."""
    if snapshot is None:
        snapshot = _metrics.snapshot()
    lines: List[str] = []
    for name in sorted(snapshot):
        m = snapshot[name]
        pn = _prom_name(name, prefix)
        kind = m.get("type")
        if kind in ("counter", "gauge"):
            lines.append(f"# TYPE {pn} {kind}")
            lines.append(f"{pn} {m.get('value', 0)}")
        elif kind == "histogram":
            lines.append(f"# TYPE {pn} summary")
            for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                v = m.get(key)
                if v is not None:
                    lines.append(f'{pn}{{quantile="{q}"}} {v}')
            lines.append(f"{pn}_sum {m.get('sum', 0)}")
            lines.append(f"{pn}_count {m.get('count', 0)}")
    # process-level series the scrape always gets
    up = prefix + "health_uptime_seconds"
    lines.append(f"# TYPE {up} gauge")
    lines.append(f"{up} {round(time.time() - _START_TIME, 3)}")
    try:
        from .tracer import get_tracer
        t = get_tracer()
        td = prefix + "tracer_dropped_total"
        lines.append(f"# TYPE {td} counter")
        lines.append(f"{td} {t.dropped}")
    except Exception:
        pass
    for rep in slo_reports():
        model = rep["model"].replace('"', "'")
        for wname, win in rep["windows"].items():
            for key in ("error_burn", "latency_burn"):
                if key in win:
                    mn = prefix + f"slo_{key}"
                    lines.append(
                        f'{mn}{{model="{model}",window="{wname}"}} '
                        f'{win[key]}')
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# /healthz snapshot
# ----------------------------------------------------------------------
def health_snapshot() -> Dict[str, Any]:
    """The ``/healthz`` JSON — also usable offline (``obs-report
    --health``): status board, tracer drop count, device-memory
    watermark gauges, SLO reports, flight-recorder state."""
    status = get_status()
    snap = _metrics.snapshot()
    device_memory = {
        name: m.get("value") for name, m in sorted(snap.items())
        if m.get("type") == "gauge" and "device" in name and "bytes" in name
    }
    tracer_info: Dict[str, Any] = {}
    try:
        from .tracer import get_tracer
        t = get_tracer()
        tracer_info = {"spans": len(t.spans()), "dropped": t.dropped,
                       "capacity": t.capacity,
                       "open_spans": len(t.open_spans())}
    except Exception:
        pass
    flight_info: Dict[str, Any] = {}
    last_event_ts: Optional[float] = None
    try:
        from . import flight as _flight
        rec = _flight.get_recorder()
        if rec is not None:
            last = rec.last_event()
            last_event_ts = last.get("ts") if last else None
            flight_info = {"path": rec.path, "events": len(rec.snapshot()),
                           "dumps": rec.dump_count}
    except Exception:
        pass
    slos = slo_reports()
    return {
        "ok": bool(status.get("numeric_ok", True))
        and not any(r.get("breached") for r in slos),
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _START_TIME, 3),
        "run_id": status.get("run_id"),
        "stage": status.get("stage"),
        "iteration": status.get("iteration"),
        "status": status,
        "last_event_ts": last_event_ts,
        "tracer": tracer_info,
        "device_memory": device_memory,
        "slo": slos,
        "flight": flight_info,
    }


# ----------------------------------------------------------------------
# exposition server
# ----------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    server_version = "lgbtpu-health/1"

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path in ("/healthz", "/health", "/"):
                body = (json.dumps(health_snapshot(), default=str)
                        + "\n").encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
        except Exception as exc:   # a scrape must never kill the server
            body = json.dumps({"error": str(exc)}).encode()
            self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class HealthServer:
    """Background-thread HTTP exposition bound to 127.0.0.1."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="lgbtpu-health",
            kwargs={"poll_interval": 0.25}, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)


_SERVER: Optional[HealthServer] = None
_SERVER_LOCK = threading.Lock()


def start_health_server(port: int) -> Optional[HealthServer]:
    """Start (or return) the process health server.  Idempotent — the
    first successful bind wins; a bind failure warns and returns None
    (a busy port must not kill training)."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            return _SERVER
        try:
            _SERVER = HealthServer(int(port))
        except OSError as exc:
            import warnings
            warnings.warn(f"obs health server failed to bind port "
                          f"{port}: {exc}", RuntimeWarning, stacklevel=2)
            return None
        set_status(health_port=_SERVER.port)
        return _SERVER


def maybe_start(port: Optional[int] = None) -> Optional[HealthServer]:
    """Start the server when enabled: explicit ``port`` (config knob)
    wins, else the ``LGBM_OBS_HEALTH_PORT`` env var (how the watcher
    arms its stage subprocesses).  ``None``/unset → no server."""
    if port is None or int(port) <= 0:
        env = os.environ.get("LGBM_OBS_HEALTH_PORT", "")
        try:
            port = int(env) if env else None
        except ValueError:
            port = None
        if port is None:
            return _SERVER
    return start_health_server(int(port))


def get_server() -> Optional[HealthServer]:
    return _SERVER


def stop_health_server() -> None:
    """Test seam."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None

