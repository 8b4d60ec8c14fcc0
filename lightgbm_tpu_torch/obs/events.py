"""Structured run events: one schema, one writer, one results file.

Every measurement in the repo lands in ``perf_results.jsonl`` (or the
file ``WATCHER_PERF_LOG`` points at).  Historically each bench script
carried its own copy of the path resolution and a bare ``json.dumps``
append; this module is the single replacement:

- :func:`perf_log_path` — the one copy of the ``WATCHER_PERF_LOG``-or-
  repo-root resolution previously duplicated across six scripts;
- :class:`EventLog` — a thread-safe, atomic-append jsonl sink stamping
  every record with the versioned envelope (``schema_version``,
  ``run_id``, wall clock ``ts``, monotonic clock ``mono``, ``event``);
- :func:`validate_event` / :func:`classify_record` — the schema
  validator the report layer uses to tolerate legacy (pre-schema) lines.

Compatibility: the envelope keeps a ``stage`` field mirroring ``event``
(unless the caller sets its own) because the perf-suite resume markers
and the watcher journal key on ``stage`` — old readers keep working on
new lines, and the report reader accepts old lines.

This module is deliberately stdlib-only (the port's copy of the JAX
package's ``obs/events.py``): a supervising process can load it without
torch, and the journal lines are the same in both packages.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

#: bump when the envelope changes shape; readers tolerate every version
#: they know plus pre-schema ("legacy") lines
SCHEMA_VERSION = 1

#: envelope fields every schema event carries
REQUIRED_FIELDS = ("schema_version", "run_id", "event", "ts", "mono")

#: the event kind marking a bench script's final one-JSON-line summary
SUMMARY_EVENT = "bench_summary"

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def perf_log_path(env: Optional[Dict[str, str]] = None) -> str:
    """The results file: ``WATCHER_PERF_LOG`` when the watcher points every
    stage at one journal, else the repo-root ``perf_results.jsonl``."""
    env = os.environ if env is None else env
    return env.get("WATCHER_PERF_LOG") or os.path.join(
        _REPO_ROOT, "perf_results.jsonl")


def new_run_id() -> str:
    """Short unique id correlating every event of one process/run."""
    return uuid.uuid4().hex[:12]


def make_event(event: str, run_id: str, **fields: Any) -> Dict[str, Any]:
    """Build a schema-stamped record (no I/O).  Caller fields win over
    nothing — envelope keys are reserved and always overwritten."""
    rec = dict(fields)
    rec["schema_version"] = SCHEMA_VERSION
    rec["run_id"] = run_id
    rec["event"] = str(event)
    rec["ts"] = time.time()
    rec["mono"] = time.monotonic()
    # legacy-reader compat: suite resume markers / watcher records key on
    # "stage"; mirror the kind unless the caller carries its own stage
    rec.setdefault("stage", rec["event"])
    return rec


def validate_event(rec: Any) -> List[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    for k in REQUIRED_FIELDS:
        if k not in rec:
            errs.append(f"missing field {k!r}")
    if errs:
        return errs
    if not isinstance(rec["schema_version"], int) or rec["schema_version"] < 1:
        errs.append("schema_version must be an int >= 1")
    if not isinstance(rec["run_id"], str) or not rec["run_id"]:
        errs.append("run_id must be a non-empty string")
    if not isinstance(rec["event"], str) or not rec["event"]:
        errs.append("event must be a non-empty string")
    for k in ("ts", "mono"):
        if not isinstance(rec[k], (int, float)) or isinstance(rec[k], bool):
            errs.append(f"{k} must be a number")
    return errs


def classify_record(line: str) -> Tuple[str, Optional[Dict[str, Any]]]:
    """Classify one jsonl line: ``("event", rec)`` for schema-valid records,
    ``("legacy", rec)`` for pre-schema JSON objects (the six old writers'
    shapes), ``("bad", None)`` for anything unparseable/invalid."""
    line = line.strip()
    if not line:
        return "bad", None
    try:
        rec = json.loads(line)
    except (ValueError, TypeError):
        return "bad", None
    if not isinstance(rec, dict):
        return "bad", None
    if "schema_version" not in rec:
        return "legacy", rec
    return ("event", rec) if not validate_event(rec) else ("bad", rec)


class EventLog:
    """Thread-safe atomic-append jsonl sink with the schema envelope.

    Each record is serialized to one line and written with a single
    ``write`` call on a file opened in append mode, so concurrent writers
    (serve worker threads, the watcher's stage subprocesses sharing
    ``WATCHER_PERF_LOG``) interleave whole lines, never fragments.

    ``echo=True`` also prints each line to stdout (the bench scripts'
    historical behavior — the suite/watcher scrape stdout for progress).
    """

    _defaults: Dict[str, "EventLog"] = {}
    _defaults_lock = threading.Lock()

    #: process-wide record taps (the flight recorder's ring).  Class level
    #: on purpose: a dump must see events from EVERY log in the process
    #: (telemetry journal + serve log + ad-hoc EventLogs), and observers
    #: outlive any single log instance.
    _observers: List[Any] = []

    @classmethod
    def add_observer(cls, fn: Any) -> None:
        """Register ``fn(rec)`` to be called (outside the write lock) with
        every record any :class:`EventLog` in the process appends.
        Observer exceptions are swallowed — a broken tap must never break
        the journal."""
        with cls._defaults_lock:
            if fn not in cls._observers:
                cls._observers.append(fn)

    @classmethod
    def remove_observer(cls, fn: Any) -> None:
        with cls._defaults_lock:
            if fn in cls._observers:
                cls._observers.remove(fn)

    @classmethod
    def _notify(cls, rec: Dict[str, Any]) -> None:
        for fn in list(cls._observers):
            try:
                fn(rec)
            except Exception:
                pass

    def __init__(self, path: Optional[str] = None, *,
                 run_id: Optional[str] = None, echo: bool = False):
        self.path = path or perf_log_path()
        self.run_id = run_id or new_run_id()
        self.echo = bool(echo)
        self._lock = threading.Lock()

    @classmethod
    def default(cls, *, echo: bool = False) -> "EventLog":
        """Process-wide log for the resolved :func:`perf_log_path` (one
        ``run_id`` per process per path).  ``echo=True`` upgrades an
        existing silent default — bench mains want echo, library callers
        don't care."""
        path = perf_log_path()
        with cls._defaults_lock:
            log = cls._defaults.get(path)
            if log is None:
                log = cls(path, echo=echo)
                cls._defaults[path] = log
            elif echo:
                log.echo = True
            return log

    # ------------------------------------------------------------------
    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        """Append one schema-stamped record; returns it."""
        rec = make_event(event, self.run_id, **fields)
        self._write(rec)
        return rec

    def emit_raw(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """Append a caller-built record verbatim (no envelope) — for
        relaying already-stamped records (e.g. the watcher forwarding a
        stage's summary)."""
        self._write(rec)
        return rec

    def summary(self, **fields: Any) -> Dict[str, Any]:
        """Emit a bench script's final summary: appended to the log AND
        printed as the last stdout line (the one-JSON-line contract,
        ``supervise.extract_json_line``).  Validates before writing so a
        malformed summary fails the bench loudly, not the reader later.

        Surfaces the tracer's silent data loss: when the process tracer has
        dropped spans (ring overflow) the summary carries a
        ``tracer_dropped`` count so no bench can claim complete span
        coverage it doesn't have."""
        if "tracer_dropped" not in fields:
            try:  # lazy: keep module import order free of cycles
                from .tracer import get_tracer
                dropped = get_tracer().dropped
            except Exception:
                dropped = 0
            if dropped:
                fields["tracer_dropped"] = dropped
        rec = make_event(SUMMARY_EVENT, self.run_id, **fields)
        errs = validate_event(rec)
        if errs:
            raise ValueError(f"invalid bench summary: {'; '.join(errs)}")
        line = json.dumps(rec)
        with self._lock:
            self._append_line(line)
        print(line, flush=True)
        self._notify(rec)
        return rec

    # ------------------------------------------------------------------
    def _write(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec)
        with self._lock:
            self._append_line(line)
        if self.echo:
            print(line, flush=True)
        self._notify(rec)

    def _append_line(self, line: str) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
