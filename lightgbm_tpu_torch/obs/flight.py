"""Flight recorder: crash-proof forensics for live runs.

Post-hoc telemetry (``events.py`` journals) answers "what happened" only
when the process got to write it.  A stage that is SIGKILLed by the
watcher's hang reaper, segfaults inside a native library, or dies to an unhandled
exception leaves an exit code and a truncated journal.  This module
keeps a bounded in-memory ring of the last N schema events (tapped off
:class:`~lightgbm_tpu_torch.obs.events.EventLog` via its observer hook) plus
the open-span tails of every thread, and flushes them atomically to
``flight_<run_id>.jsonl``:

- eagerly every ``flush_every`` records (SIGKILL cannot be caught — the
  last periodic flush IS the forensic record for a hard kill);
- on ``atexit``, on an unhandled exception (chained ``sys.excepthook``),
  and on the ``faulthandler``-style fatal/termination signals (handler
  dumps, restores the previous disposition, and re-raises so exit
  status is preserved).

Dump layout (one JSON object per line, all schema-stamped):
``flight_dump`` header (reason, pid, counts, tracer ``dropped``), then
the ring's events oldest-first, then ``flight_span`` records — the
completed-span tail and every thread's still-open spans (``open: true``
with the span's age).

Destination precedence: the ``LGBM_FLIGHT_DIR`` environment variable
(how ``supervise.run_stage`` redirects a child's dump into a collectible
location) beats the ``dir`` argument beats the directory of
:func:`~lightgbm_tpu_torch.obs.events.perf_log_path`.

Deliberately stdlib-only (the port's copy of the JAX package's
``obs/flight.py``): it loads without torch or numpy in the interpreter.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional

from .events import EventLog, make_event, new_run_id, perf_log_path

__all__ = ["FlightRecorder", "install", "get_recorder", "uninstall",
           "dump", "FATAL_SIGNALS"]

#: prefix of every dump file (``supervise.run_stage`` globs on it)
FLIGHT_PREFIX = "flight_"

#: termination/fatal signals the recorder dumps on.  SIGINT is left
#: alone (KeyboardInterrupt reaches the excepthook path); SIGKILL is
#: uncatchable by design — covered by the eager periodic flush.
FATAL_SIGNALS = ("SIGTERM", "SIGQUIT", "SIGABRT",
                 "SIGSEGV", "SIGBUS", "SIGFPE", "SIGILL")


class FlightRecorder:
    """Bounded event ring + span tails with atomic crash dumps."""

    def __init__(self, dir: Optional[str] = None,
                 run_id: Optional[str] = None, *,
                 capacity: int = 256, flush_every: int = 32,
                 span_tail: int = 64):
        env_dir = os.environ.get("LGBM_FLIGHT_DIR")
        self.dir = env_dir or dir or os.path.dirname(
            os.path.abspath(perf_log_path()))
        self.run_id = run_id or new_run_id()
        self.capacity = int(capacity)
        self.flush_every = max(1, int(flush_every))
        self.span_tail = int(span_tail)
        self.path = os.path.join(
            self.dir, f"{FLIGHT_PREFIX}{self.run_id}.jsonl")
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._since_flush = 0
        self.dump_count = 0
        self._installed = False
        self._prev_excepthook: Any = None
        self._prev_handlers: Dict[int, Any] = {}
        self._in_dump = False

    # ------------------------------------------------------------------
    def record(self, rec: Dict[str, Any]) -> None:
        """Ring in one already-stamped record (the EventLog observer)."""
        flush = False
        with self._lock:
            self._ring.append(rec)
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._since_flush = 0
                flush = True
        if flush:
            self.dump("periodic")

    def note(self, event: str, **fields: Any) -> Dict[str, Any]:
        """Stamp + ring a record directly (no journal write): for facts
        that only matter if the process dies."""
        rec = make_event(event, self.run_id, **fields)
        self.record(rec)
        return rec

    def last_event(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._ring[-1]) if self._ring else None

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._ring]

    # ------------------------------------------------------------------
    def _span_records(self) -> List[Dict[str, Any]]:
        try:
            from .tracer import get_tracer
            t = get_tracer()
        except Exception:
            return []
        recs: List[Dict[str, Any]] = []
        try:
            for s in t.spans()[-self.span_tail:]:
                recs.append(make_event(
                    "flight_span", self.run_id, name=s.name, tid=s.tid,
                    depth=s.depth, duration_s=round(s.duration, 6),
                    open=False))
            for o in t.open_spans():
                recs.append(make_event(
                    "flight_span", self.run_id, name=o["name"],
                    tid=o["tid"], depth=o["depth"], age_s=o["age_s"],
                    open=True))
        except Exception:
            pass
        return recs

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Atomically (tmp + ``os.replace``) write the dump file; returns
        its path, or None if a concurrent dump is already writing."""
        with self._lock:
            if self._in_dump:       # re-entrant signal during a dump
                return None
            self._in_dump = True
            events = [dict(r) for r in self._ring]
            self._since_flush = 0
        try:
            spans = self._span_records()
            try:
                from .tracer import get_tracer
                dropped = get_tracer().dropped
            except Exception:
                dropped = 0
            header = make_event(
                "flight_dump", self.run_id, reason=str(reason),
                pid=os.getpid(), events=len(events), spans=len(spans),
                tracer_dropped=dropped)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "w") as f:
                for rec in [header] + events + spans:
                    f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.dump_count += 1
            return self.path
        except Exception:
            return None         # a recorder must never crash its host
        finally:
            with self._lock:
                self._in_dump = False

    # ------------------------------------------------------------------
    def install(self) -> "FlightRecorder":
        """Tap the EventLog stream and arm atexit/excepthook/signal
        dumps.  Idempotent."""
        if self._installed:
            return self
        self._installed = True
        EventLog.add_observer(self.record)
        atexit.register(self._atexit)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        for name in FATAL_SIGNALS:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_signal)
            except (ValueError, OSError, RuntimeError):
                pass    # non-main thread or unsupported signal
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        EventLog.remove_observer(self.record)
        try:
            atexit.unregister(self._atexit)
        except Exception:
            pass
        if sys.excepthook is self._excepthook:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        for sig, prev in self._prev_handlers.items():
            try:
                if signal.getsignal(sig) is self._on_signal:
                    signal.signal(sig, prev)
            except (ValueError, OSError, RuntimeError):
                pass
        self._prev_handlers.clear()

    # ------------------------------------------------------------------
    def _atexit(self) -> None:
        if self._ring or self.dump_count:
            self.dump("atexit")

    def _excepthook(self, etype, value, tb) -> None:
        try:
            tail = traceback.format_exception(etype, value, tb)[-8:]
            self.note("unhandled_exception", type=etype.__name__,
                      message=str(value)[:500],
                      traceback_tail="".join(tail)[-2000:])
            self.dump("exception")
        except Exception:
            pass
        prev = self._prev_excepthook or sys.__excepthook__
        prev(etype, value, tb)

    def _on_signal(self, signum, frame) -> None:
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        try:
            self.note("fatal_signal", signal=name, signum=int(signum))
            self.dump(f"signal_{name}")
        except Exception:
            pass
        # restore the previous disposition and re-raise: the process dies
        # with the status the signal implies (watcher reaping semantics,
        # shell wait status) instead of a handler swallowing it
        prev = self._prev_handlers.get(signum)
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError, RuntimeError):
            pass
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        else:
            os.kill(os.getpid(), signum)


# ----------------------------------------------------------------------
_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()


def install(dir: Optional[str] = None, run_id: Optional[str] = None,
            **kwargs: Any) -> FlightRecorder:
    """Install the process-wide recorder (idempotent: the first install
    wins — one flight file per process)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder(dir, run_id, **kwargs).install()
        return _RECORDER


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def uninstall() -> None:
    """Tear down the process recorder (tests)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is not None:
            _RECORDER.uninstall()
            _RECORDER = None


def dump(reason: str = "manual") -> Optional[str]:
    """Dump now if a recorder is installed; returns the dump path."""
    rec = _RECORDER
    return rec.dump(reason) if rec is not None else None
