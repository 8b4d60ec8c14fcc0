"""String-keyed hierarchical wall-clock timer.

Parity with the reference's ``Common::Timer`` / ``FunctionTimer``
(``include/LightGBM/utils/common.h:931,995``): named accumulating scopes and an
aggregate printout.  On the card the heavyweight profiling story
is ``torch.profiler``; this host timer exists for quick parity-style
breakdowns of the boosting loop.

Thread-safety and nesting: ``global_timer`` is shared by the boosting loop
AND the serve worker threads, so the accumulators sit behind a lock and the
in-flight starts live in per-thread stacks — the same scope name may nest
(recursive helpers) and run concurrently on many threads without corrupting
each other's start times.  When a tracer is attached
(``attach_tracer``, see ``obs/tracer.py``), every scope additionally records
a span, turning the aggregate timer into a timeline with zero call-site
changes.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

from .log import Log


class Timer:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)
        self._local = threading.local()
        self._tracer = None

    # ------------------------------------------------------------------
    def _starts(self) -> "dict[str, list[float]]":
        st = getattr(self._local, "starts", None)
        if st is None:
            st = self._local.starts = defaultdict(list)
        return st

    def attach_tracer(self, tracer) -> None:
        """Mirror every scope into ``tracer`` as a span (obs.tracer API:
        ``begin(name)`` / ``end(name)``)."""
        self._tracer = tracer

    def detach_tracer(self) -> None:
        self._tracer = None

    # ------------------------------------------------------------------
    def start(self, name: str) -> None:
        self._starts()[name].append(time.perf_counter())
        t = self._tracer
        if t is not None:
            t.begin(name)

    def stop(self, name: str) -> None:
        stack = self._starts().get(name)
        if not stack:
            return
        t0 = stack.pop()
        dt = time.perf_counter() - t0
        with self._lock:
            self._acc[name] += dt
            self._count[name] += 1
        t = self._tracer
        if t is not None:
            t.end(name)

    @contextlib.contextmanager
    def scope(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    # ------------------------------------------------------------------
    def seconds(self, name: str) -> float:
        """Accumulated seconds for one scope (0.0 when never stopped)."""
        with self._lock:
            return self._acc.get(name, 0.0)

    def calls(self, name: str) -> int:
        with self._lock:
            return self._count.get(name, 0)

    def items(self):
        with self._lock:
            return sorted(self._acc.items(), key=lambda kv: -kv[1])

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()
            self._count.clear()
        # only the calling thread's in-flight starts can be dropped here;
        # other threads' stacks are theirs to unwind
        starts = getattr(self._local, "starts", None)
        if starts is not None:
            starts.clear()

    def print(self) -> None:
        for name, secs in self.items():
            Log.debug("%s: %.3fs (%d calls)", name, secs, self.calls(name))


#: process-global timer, mirroring the reference's ``global_timer``
global_timer = Timer()
