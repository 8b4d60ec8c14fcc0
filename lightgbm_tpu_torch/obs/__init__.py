"""Unified telemetry: structured events, metrics, tracing, reporting.

The port's observability subsystem, a copy of the JAX package's ``obs/``
(docs/OBSERVABILITY.md) writing the same journal records.  Four layers,
all stdlib-only at import (torch is imported where a device is read):

- :mod:`.events` — versioned structured-event schema + the thread-safe
  jsonl :class:`~.events.EventLog` behind ``perf_results.jsonl``;
- :mod:`.metrics` — process-wide counters/gauges/reservoir-percentile
  histograms, snapshottable on demand;
- :mod:`.tracer` — nested, thread-safe spans exporting Chrome trace JSON
  and (optionally) riding ``torch.profiler.record_function`` and NVTX
  ranges;
- :mod:`.report` — the ``python -m lightgbm_tpu_torch obs-report`` renderer.

:class:`TrainTelemetry` is the glue the boosting loops hold: one object
wiring config knobs (``obs_telemetry``, ``obs_events_path``,
``obs_trace_device``) to an event log, the metrics registry, the global
tracer, and the ``global_timer`` -> tracer span bridge.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from . import costs, flight, health, regress
from .costs import CostLedger, get_ledger
from .events import (EventLog, SCHEMA_VERSION, classify_record, make_event,
                     new_run_id, perf_log_path, validate_event)
from .flight import FlightRecorder
from .health import DivergenceError, SLOMonitor
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_registry)
from .tracer import DeviceRange, Span, Tracer, device_ranged, get_tracer

__all__ = ["EventLog", "SCHEMA_VERSION", "classify_record", "make_event",
           "new_run_id", "perf_log_path", "validate_event",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "Span", "Tracer", "get_tracer", "DeviceRange",
           "device_ranged",
           "costs", "regress", "CostLedger", "get_ledger",
           "flight", "health", "FlightRecorder", "DivergenceError",
           "SLOMonitor", "TrainTelemetry"]


class TrainTelemetry:
    """Per-booster telemetry hook (constructed when ``obs_telemetry`` is
    on; the boosting loop holds ``None`` otherwise, so the off path costs
    one attribute check per iteration).

    Wires the config to the subsystem: events go to ``obs_events_path``
    (default: the shared perf journal), per-iteration seconds feed named
    histograms in the process registry, and ``global_timer`` scopes are
    bridged into the global tracer so the ``GBDT::*`` scopes become
    nested spans under each iteration's ``train/iteration`` span (each
    also a ``torch.profiler.record_function`` range, and on a CUDA
    ``device`` an NVTX range, when ``obs_trace_device`` is set).
    """

    #: the global_timer scope names whose per-iteration deltas are
    #: reported as phase seconds (the streaming loop's join them when it
    #: is ported)
    PHASE_SCOPES = ("GBDT::gradients", "GBDT::grow_tree",
                    "GBDT::update_score")

    def __init__(self, config: Any, kind: str = "train", device: Any = None):
        self.kind = kind
        path = getattr(config, "obs_events_path", "") or None
        self.log = EventLog(path) if path else EventLog.default()
        self.run_id = self.log.run_id
        self.metrics = get_registry()
        self.reservoir = int(getattr(config, "obs_reservoir_size", 512))
        self.tracer = get_tracer()
        self.tracer.annotate_device = bool(
            getattr(config, "obs_trace_device", False))
        self.device = device
        self.tracer.nvtx = getattr(device, "type", None) == "cuda"
        from ..utils.timer import global_timer
        self._timer = global_timer
        global_timer.attach_tracer(self.tracer)
        self._phase_base: Dict[str, float] = {}
        # health plane: arm the flight recorder (dump lands beside the
        # journal unless LGBM_FLIGHT_DIR redirects it), publish the run
        # on the status board, start the exposition server when enabled
        flight.install(dir=os.path.dirname(os.path.abspath(self.log.path)),
                       run_id=self.run_id)
        health.set_status(run_id=self.run_id, stage=self.kind)
        health.maybe_start(getattr(config, "obs_health_port", 0))

    # ------------------------------------------------------------------
    def step(self, it: int):
        """Context for one boosting iteration: a ``train/iteration`` span
        (a device range carrying the step when device tracing is on)."""
        return self.tracer.step("train/iteration", step=it)

    def phase_mark(self) -> None:
        """Remember the timer's accumulators at iteration start; the
        iteration event reports the deltas (phase seconds come from the
        host scopes)."""
        self._phase_base = {n: self._timer.seconds(n)
                            for n in self.PHASE_SCOPES}

    def phase_seconds(self) -> Dict[str, float]:
        out = {}
        for n in self.PHASE_SCOPES:
            dt = self._timer.seconds(n) - self._phase_base.get(n, 0.0)
            if dt > 0.0:
                short = n.split("::", 1)[-1]
                out[short] = round(dt, 6)
        return out

    # ------------------------------------------------------------------
    def iteration_event(self, it: int, *, trees: int,
                        extra: Optional[Dict[str, Any]] = None) -> None:
        """Emit the per-iteration training event + update metrics."""
        phases = self.phase_seconds()
        self.metrics.counter(f"{self.kind}.iterations").inc()
        for name, secs in phases.items():
            self.metrics.histogram(f"{self.kind}.{name}_seconds",
                                   self.reservoir).observe(secs)
        rec: Dict[str, Any] = {"iteration": it, "trees": trees,
                               "phase_seconds": phases}
        # device-memory watermarks (the allocator's host-side counters, no
        # device sync; the CPU has none and the helper returns {}) + the
        # cost-ledger wall-time join for the recorded grow program
        wm = costs.record_watermarks(self.kind, self.metrics, self.device)
        if wm:
            rec["device_memory"] = wm
        if "grow_tree" in phases:
            get_ledger().observe(f"{self.kind}.grow_tree",
                                 phases["grow_tree"])
        if extra:
            rec.update(extra)
        self.log.emit(f"{self.kind}_iter", **rec)
        health.set_status(stage=self.kind, iteration=it)
        # surface the tracer's silent data loss once per overflow episode
        if self.tracer.dropped and not self.tracer.overflow_reported:
            self.tracer.overflow_reported = True
            self.log.emit("tracer_overflow", level="warning",
                          dropped=self.tracer.dropped,
                          capacity=self.tracer.capacity)

    def tree_event(self, it: int, *, num_leaves: int,
                   split_gains: Optional[List[float]] = None) -> None:
        """Per-materialized-tree stats: leaves + split-gain summary.  On
        the fast path this fires from ``_drain_pending`` (the existing
        host materialization point) so telemetry never forces an extra
        device sync."""
        self.metrics.histogram(f"{self.kind}.num_leaves",
                               self.reservoir).observe(num_leaves)
        rec: Dict[str, Any] = {"iteration": it, "num_leaves": num_leaves}
        if split_gains:
            gains = [float(g) for g in split_gains]
            rec["split_gain"] = {
                "splits": len(gains),
                "max": round(max(gains), 6),
                "mean": round(sum(gains) / len(gains), 6),
                "total": round(sum(gains), 6)}
            self.metrics.histogram(f"{self.kind}.split_gain",
                                   self.reservoir).observe(max(gains))
        self.log.emit(f"{self.kind}_tree", **rec)

    def close(self) -> None:
        self._timer.detach_tracer()
