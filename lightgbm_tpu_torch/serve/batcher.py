"""Micro-batching request queue: coalesce, pad, fan out, shed.

The port's copy of the JAX package's ``serve/batcher.py`` (host code; the
port's ``obs`` and ``utils.log`` in place of the JAX package's).

Single-row requests are the common serving shape but the worst compute
shape: a device traversal of 1 row costs nearly the same as 1024 rows.  The
:class:`MicroBatcher` turns many small concurrent requests into one
bucket-shaped call:

- ``submit`` enqueues a request and returns a ``Future``; a dedicated
  worker thread pops the first request, then keeps coalescing until the
  batch deadline passes or the coalesced rows reach the largest bucket;
- the coalesced matrix runs through ONE ``predict_fn`` call (the
  artifact pads it to the nearest bucket) and results fan back out to the
  per-request futures by row offset;
- a bounded queue sheds load gracefully: when ``queue_depth`` requests are
  already pending, ``submit`` refuses immediately with
  :class:`QueueSaturatedError` instead of letting latency collapse.

Supervision idioms follow ``utils/supervise.py``: the optional
``heartbeat`` is any ``(event, **fields)`` callable (e.g.
``supervise.Heartbeat``) and a worker-thread crash marks the batcher
broken and fails pending futures instead of hanging their callers.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from ..obs import costs as obs_costs
from ..obs import metrics as obs_metrics
from ..utils.log import LightGBMError

__all__ = ["MicroBatcher", "QueueSaturatedError"]


class QueueSaturatedError(LightGBMError):
    """The request queue is full; the caller should back off and retry."""


_STOP = object()


class MicroBatcher:
    """Deadline-bounded micro-batching front end over a ``predict_fn``.

    Args:
      predict_fn: ``(X [rows, F] np.ndarray) -> np.ndarray`` whose result's
        leading axis aligns with rows (extra axes allowed, e.g. ``[rows, K]``).
      max_batch_rows: stop coalescing once this many rows are gathered
        (set it to the artifact's largest bucket).
      deadline_ms: how long the first request of a batch may wait for
        company before the batch is flushed.
      queue_depth: max pending REQUESTS before ``submit`` sheds.
      heartbeat: optional ``(event, **fields)`` observability callable.
    """

    def __init__(self, predict_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch_rows: int = 262144, deadline_ms: float = 2.0,
                 queue_depth: int = 64, name: str = "default",
                 num_features: Optional[int] = None, heartbeat=None,
                 slo=None):
        if max_batch_rows < 1:
            raise LightGBMError("max_batch_rows must be >= 1")
        if deadline_ms < 0:
            raise LightGBMError("deadline_ms must be >= 0")
        if queue_depth < 1:
            raise LightGBMError("queue_depth must be >= 1")
        self._predict = predict_fn
        # requests coalesce by concatenation, so ONE malformed width must
        # be refused at the door, not allowed to poison a shared batch;
        # inferred from the first request when not pinned by the caller
        self._n_features = num_features
        self.max_batch_rows = int(max_batch_rows)
        self.deadline = float(deadline_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.name = name
        self._hb = heartbeat or (lambda event, **kv: None)
        # optional obs.health.SLOMonitor: fed one observation per request
        # outcome (latency on success, bad=True on shed/error) so the
        # health plane tracks multi-window burn rates per model
        self.slo = slo
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._closed = False
        # makes submit's closed-check atomic with close()'s flag flip: a
        # put that raced past a bare flag check could land AFTER close()
        # drained the queue, hanging its caller forever
        self._lifecycle = threading.Lock()
        self._broken: Optional[BaseException] = None
        self.stats = {"requests": 0, "batches": 0, "rows": 0,
                      "shed": 0, "max_batch_requests": 0}
        # process-wide serve metrics (docs/OBSERVABILITY.md): counters
        # mirror self.stats; the latency/shape histograms have no
        # per-batcher equivalent and are the online p50-p99 source
        self._m_requests = obs_metrics.counter("serve.requests")
        self._m_shed = obs_metrics.counter("serve.shed")
        self._m_errors = obs_metrics.counter("serve.errors")
        self._m_qdepth = obs_metrics.gauge("serve.queue_depth")
        self._m_batch_rows = obs_metrics.histogram("serve.batch_rows")
        self._m_batch_reqs = obs_metrics.histogram("serve.batch_requests")
        self._m_request_ms = obs_metrics.histogram("serve.request_ms")
        self._worker = threading.Thread(
            target=self._loop, name=f"lgbm-serve-batcher-{name}", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, X) -> Future:
        """Enqueue one request; returns a ``Future`` resolving to its
        prediction rows.  Refuses immediately when closed, broken, or
        saturated — a serving queue must fail fast, never block."""
        if self._closed:
            raise LightGBMError(f"batcher {self.name!r} is closed")
        if self._broken is not None:
            raise LightGBMError(
                f"batcher {self.name!r} worker died: {self._broken!r}")
        X = np.asarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2:
            raise LightGBMError(
                f"batcher {self.name!r} expects [rows, features] requests, "
                f"got ndim={X.ndim}")
        if self._n_features is None:
            self._n_features = int(X.shape[1])
        elif X.shape[1] != self._n_features:
            raise LightGBMError(
                f"batcher {self.name!r} expects {self._n_features} "
                f"features, request has {X.shape[1]}")
        fut: Future = Future()
        with self._lifecycle:
            if self._closed:
                raise LightGBMError(f"batcher {self.name!r} is closed")
            try:
                self._q.put_nowait((X, fut))
            except queue.Full:
                self.stats["shed"] += 1
                self._m_shed.inc()
                if self.slo is not None:
                    self.slo.observe(bad=True)
                self._hb("shed", batcher=self.name, pending=self._q.qsize())
                raise QueueSaturatedError(
                    f"serving queue {self.name!r} saturated "
                    f"({self.queue_depth} pending requests): request refused "
                    "— retry with backoff or raise serve_queue_depth"
                ) from None
        self.stats["requests"] += 1
        self._m_requests.inc()
        self._m_qdepth.set(self._q.qsize())
        if self._broken is not None:
            # the worker may have crashed and run ITS drain between the
            # check at the top and our put; it has exited, so nobody will
            # ever service the queue again — drain once more (failing our
            # own future too) rather than leave the caller hanging
            self._fail_pending(LightGBMError(
                f"batcher {self.name!r} worker died: {self._broken!r}"))
        return fut

    def predict(self, X, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: ``submit`` + wait.  The measured span
        (enqueue -> result) is the caller-observed online latency feeding
        ``serve.request_ms`` p50-p99."""
        t0 = time.perf_counter()
        try:
            out = self.submit(X).result(timeout)
        except Exception:
            # sheds already fed the monitor in submit(); anything else
            # (worker error, timeout) is a bad request outcome too
            if self.slo is not None and not isinstance(
                    sys.exc_info()[1], QueueSaturatedError):
                self.slo.observe(bad=True)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        self._m_request_ms.observe(ms)
        if self.slo is not None:
            self.slo.observe(latency_ms=ms)
        return out

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting requests, drain what's queued, join the worker."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
        # any submit that saw _closed False completed its put before the
        # flag flipped (both under _lifecycle), so its request is ahead of
        # this sentinel: the worker serves it or the drain below fails it.
        # The sentinel must land WITHOUT blocking forever: a wedged
        # predict_fn can pin the worker while the queue sits full, and
        # close() honoring its timeout matters more than those doomed
        # requests — fail them to free a slot.
        try:
            self._q.put_nowait(_STOP)
        except queue.Full:
            self._fail_pending(LightGBMError(
                f"batcher {self.name!r} closed before the request ran"))
            self._q.put_nowait(_STOP)   # just drained and submits are
            # refused under _lifecycle, so the queue cannot refill
        self._worker.join(timeout)
        # a submit that passed the closed check concurrently with close()
        # may have landed BEHIND the sentinel; with the worker gone its
        # future would hang its caller forever — fail it instead
        self._fail_pending(LightGBMError(
            f"batcher {self.name!r} closed before the request ran"))
        if self._worker.is_alive():
            # the drain above may have eaten the sentinel while the worker
            # was still mid-batch; re-send it (the queue is empty now) so
            # the worker exits after its batch instead of blocking on
            # get() forever
            try:
                self._q.put_nowait(_STOP)
            except queue.Full:
                pass

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            head = self._q.get()
            if head is _STOP:
                return
            batch = [head]
            rows = head[0].shape[0]
            stop_after = False
            deadline = time.monotonic() + self.deadline
            while rows < self.max_batch_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                batch.append(nxt)
                rows += nxt[0].shape[0]
            try:
                self._run_batch(batch)
            except BaseException as e:      # worker must never die silently
                self._broken = e
                for _, fut in batch:
                    _fail_future(fut, e)
                self._fail_pending(e)
                self._hb("worker_broken", batcher=self.name, error=repr(e))
                return
            if stop_after:
                return

    def _run_batch(self, batch) -> None:
        live = [(X, fut) for X, fut in batch
                if fut.set_running_or_notify_cancel()]
        if not live:
            return
        if len(live) > 1 and len({x.shape[1] for x, _ in live}) > 1:
            # a redeploy may legitimately change the accepted width while
            # old-width requests sit queued (see Predictor._retune_batcher):
            # serve each width on its own so the doomed stale requests fail
            # alone instead of poisoning the concatenated batch for valid
            # new-width ones.  In steady state there is ONE width and this
            # branch never runs.
            groups: "dict[int, list]" = {}
            for x, fut in live:
                groups.setdefault(x.shape[1], []).append((x, fut))
            for g in groups.values():
                self._serve_live(g)
            return
        self._serve_live(live)

    def _serve_live(self, live) -> None:
        try:
            # assembly is inside the guard too: a malformed request that
            # slipped past submit() must fail ITS batch, not kill the worker
            X = live[0][0] if len(live) == 1 else np.concatenate(
                [x for x, _ in live], axis=0)
            self.stats["batches"] += 1
            self.stats["rows"] += X.shape[0]
            self.stats["max_batch_requests"] = max(
                self.stats["max_batch_requests"], len(live))
            self._m_batch_rows.observe(int(X.shape[0]))
            self._m_batch_reqs.observe(len(live))
            self._hb("batch", batcher=self.name, requests=len(live),
                     rows=int(X.shape[0]))
            out = np.asarray(self._predict(X))
            # device-memory watermark after each served batch (local stats
            # read, no sync; degrades to a no-op on CPU backends)
            obs_costs.record_watermarks("serve")
        except Exception as e:
            self._m_errors.inc(len(live))
            for _, fut in live:
                _fail_future(fut, e)
            return
        off = 0
        for x, fut in live:
            _resolve_future(fut, out[off:off + x.shape[0]])
            off += x.shape[0]

    def _fail_pending(self, exc: BaseException) -> None:
        """Drain the queue after a worker crash/close so no caller waits
        forever."""
        fail = exc if isinstance(exc, LightGBMError) else LightGBMError(
            f"batcher {self.name!r} worker died: {exc!r}")
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is _STOP:
                continue
            _fail_future(item[1], fail)


def _fail_future(fut: Future, exc: BaseException) -> None:
    """Deliver ``exc`` whatever state the future is in (pending OR already
    marked running); cancelled/resolved futures are left alone —
    ``set_running_or_notify_cancel`` would RAISE on a running future and
    kill the caller mid-cleanup."""
    try:
        fut.set_exception(exc)
    except Exception:
        pass


def _resolve_future(fut: Future, result) -> None:
    try:
        fut.set_result(result)
    except Exception:       # cancelled between dispatch and completion
        pass
