"""Span-based tracing: nested, thread-safe, Chrome-trace exportable.

The upgrade path for ``utils/timer.py``: ``Timer`` keeps its aggregate
role (name -> total seconds), while an attached :class:`Tracer` records
every scope as a *span* — begin/end timestamps, thread id, nesting depth
— so one training run exports a timeline instead of only totals.

- Spans nest per thread (a thread-local open-span stack), so
  ``train/iteration > GBDT::grow_tree`` renders as nested bars;
- :meth:`Tracer.export_chrome_trace` writes Chrome trace-event JSON
  (``ph: "X"`` complete events, microsecond clocks) loadable in Perfetto
  / ``chrome://tracing``;
- with ``annotate_device=True`` each span also enters a
  :class:`DeviceRange`: ``torch.profiler.record_function`` (and with
  ``nvtx`` set, on a CUDA device, an NVTX range too), so when a
  ``torch.profiler`` capture is active the host spans line up with the
  kernels they launched — the host/device correlation story for the
  card.  :func:`device_ranged` labels a function the same way (the
  growers' ``lgbm/*`` phases under ``obs_trace_device``).

torch is imported lazily and only when device annotation is requested;
the module itself is stdlib-only.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "DeviceRange", "device_ranged"]


class DeviceRange:
    """A named range on the profiler's timeline:
    ``torch.profiler.record_function`` (what a ``torch.profiler`` capture
    shows as a host range over the kernels launched inside it) and, with
    ``nvtx``, ``torch.cuda.nvtx.range_push``/``range_pop`` (what an NVTX
    tool shows on the CUDA device).  ``open``/``close`` pair like
    ``__enter__``/``__exit__`` for a range that a ``with`` block cannot
    hold (one that ends at a loop's ``break``)."""

    __slots__ = ("name", "nvtx", "args", "_rf")

    def __init__(self, name: str, nvtx: bool = False,
                 args: Optional[str] = None):
        self.name = name
        self.nvtx = bool(nvtx)
        self.args = args
        self._rf = None

    def __enter__(self) -> "DeviceRange":
        import torch
        self._rf = torch.profiler.record_function(self.name, self.args)
        self._rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self.nvtx:
            import torch
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False

    open = __enter__

    def close(self) -> None:
        self.__exit__(None, None, None)


def device_ranged(name: str, fn: Any, nvtx: bool = False) -> Any:
    """``fn`` run inside a :class:`DeviceRange` named ``name`` on every
    call.  Callers wrap a function only when device tracing is on, so the
    off path calls the bare function."""
    @functools.wraps(fn)
    def ranged(*args: Any, **kwargs: Any) -> Any:
        with DeviceRange(name, nvtx):
            return fn(*args, **kwargs)
    return ranged


class Span:
    """One completed scope."""

    __slots__ = ("name", "start", "duration", "tid", "depth", "args")

    def __init__(self, name: str, start: float, duration: float,
                 tid: int, depth: int, args: Optional[Dict[str, Any]]):
        self.name = name
        self.start = start          # perf_counter seconds
        self.duration = duration    # seconds
        self.tid = tid
        self.depth = depth
        self.args = args


class _OpenSpan:
    __slots__ = ("name", "start", "args", "annotation")

    def __init__(self, name, start, args, annotation):
        self.name = name
        self.start = start
        self.args = args
        self.annotation = annotation    # entered DeviceRange or None


class Tracer:
    """Thread-safe span recorder with bounded memory.

    ``capacity`` bounds retained spans; beyond it new spans are counted in
    ``dropped`` instead of stored (a tracer must never become the leak it
    is measuring).
    """

    def __init__(self, capacity: int = 100_000,
                 annotate_device: bool = False, nvtx: bool = False):
        self.capacity = int(capacity)
        self.annotate_device = bool(annotate_device)
        #: with annotate_device, also push an NVTX range a span (set when
        #: the traced model lives on a CUDA device)
        self.nvtx = bool(nvtx)
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self.dropped = 0
        #: set by the first ``tracer_overflow`` warning event so the
        #: warning fires once per overflow episode, not per iteration
        self.overflow_reported = False
        self._local = threading.local()
        # tid -> that thread's open-span stack; thread-locals are not
        # enumerable from another thread, and the flight recorder needs
        # the open spans of EVERY thread at crash time
        self._stacks: Dict[int, List[_OpenSpan]] = {}

    # ------------------------------------------------------------------
    def _stack(self) -> List[_OpenSpan]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            with self._lock:
                self._stacks[threading.get_ident()] = st
        return st

    def open_spans(self) -> List[Dict[str, Any]]:
        """Snapshot of every thread's currently-open spans (crash
        forensics: what was in flight when the process died)."""
        now = time.perf_counter()
        out: List[Dict[str, Any]] = []
        with self._lock:
            stacks = {tid: list(st) for tid, st in self._stacks.items()}
        for tid, stack in sorted(stacks.items()):
            for depth, o in enumerate(stack):
                out.append({"name": o.name, "tid": tid, "depth": depth,
                            "age_s": round(now - o.start, 6),
                            "args": o.args})
        return out

    def _device_annotation(self, name: str, step: Optional[int] = None):
        """Enter a :class:`DeviceRange` when device annotation is on (a
        step's range carries ``step=<n>`` as its argument)."""
        if not self.annotate_device:
            return None
        return DeviceRange(name, self.nvtx, None if step is None
                           else f"step={step}").open()

    def begin(self, name: str, step: Optional[int] = None,
              **args: Any) -> None:
        """Open a span on the calling thread (pairs with :meth:`end`)."""
        ann = self._device_annotation(name, step)
        if step is not None:
            args = dict(args, step=step)
        self._stack().append(
            _OpenSpan(name, time.perf_counter(), args or None, ann))

    def end(self, name: str) -> None:
        """Close the innermost open span named ``name`` on this thread.
        Unbalanced ends are ignored (a tracer must not crash its host)."""
        now = time.perf_counter()
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].name == name:
                open_ = stack.pop(i)
                depth = i
                break
        else:
            return
        if open_.annotation is not None:
            open_.annotation.close()
        span = Span(name, open_.start, now - open_.start,
                    threading.get_ident(), depth, open_.args)
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(span)
            else:
                self.dropped += 1

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        self.begin(name, **args)
        try:
            yield
        finally:
            self.end(name)

    @contextlib.contextmanager
    def step(self, name: str, step: int):
        """A top-level per-iteration span; with device annotation on its
        range carries the step number, so a profiler capture groups the
        iteration's kernels under one range."""
        self.begin(name, step=step)
        try:
            yield
        finally:
            self.end(name)

    # ------------------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def aggregate(self) -> Dict[str, Dict[str, Any]]:
        """Per-name totals (the ``Timer.items`` shape, from spans)."""
        out: Dict[str, Dict[str, Any]] = {}
        for s in self.spans():
            agg = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += s.duration
        return out

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self.overflow_reported = False

    # ------------------------------------------------------------------
    def export_chrome_trace(self, path: str) -> int:
        """Write Chrome trace-event JSON (Perfetto-loadable); returns the
        number of spans exported."""
        spans = self.spans()
        pid = os.getpid()
        events = []
        for s in spans:
            ev: Dict[str, Any] = {
                "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                "ts": round(s.start * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
            }
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer (what ``global_timer`` feeds when
    telemetry is on)."""
    return _TRACER
