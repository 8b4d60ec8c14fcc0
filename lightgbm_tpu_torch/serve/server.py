"""Predictor front end: per-model routing + atomic hot-swap.

The port's copy of the JAX package's ``serve/server.py``: the same
registry, protocol and routing over the port's ``PredictorArtifact`` (one
captured CUDA graph per bucket), with each model's SLO objectives
registered in the port's health plane (``obs.health.register_slo``).

A production server never restarts to ship a model.  The
:class:`Predictor` holds a registry of named models, each a
:class:`~.artifact.PredictorArtifact` (optionally fronted by a
:class:`~.batcher.MicroBatcher`), and swaps them with a three-step
protocol:

1. ``stage(name, artifact)`` — the new artifact captured its bucket
   graphs OFF the serving path (construction already did); current
   traffic is untouched.
2. ``swap(name, parity_X)`` — the staged artifact must pass its parity
   gate (captured pipeline vs an independent host-side reference on a
   caller-supplied sample).  A failing gate ROLLS BACK: the staged
   artifact is dropped, the live one keeps serving, and the failure
   reason is raised.
3. On a passing gate the registry entry flips atomically between
   requests (one attribute assignment under the registry lock).
   Requests already in flight finish on the artifact they started with —
   zero drops; requests arriving after ``swap`` returns see only the new
   artifact — zero stale routing.  ``rollback(name)`` restores the
   previous artifact with the same atomic flip.

Routing: ``predict(X, model="name")``; a single-model server routes
everything to its only entry.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..obs import health as obs_health
from ..obs import metrics as obs_metrics
from ..utils.log import LightGBMError, Log, check
from .artifact import PredictorArtifact
from .batcher import MicroBatcher

__all__ = ["Predictor"]


class _Entry:
    """One routed model: the live artifact plus swap state."""

    __slots__ = ("artifact", "staged", "previous", "generation", "batcher",
                 "slo")

    def __init__(self, artifact: PredictorArtifact):
        self.artifact = artifact
        self.staged: Optional[PredictorArtifact] = None
        self.previous: Optional[PredictorArtifact] = None
        self.generation = 1
        self.batcher: Optional[MicroBatcher] = None
        self.slo: Optional[obs_health.SLOMonitor] = None


class Predictor:
    """Multi-model serving front end with hot-swap.

    Args:
      artifact: optional initial model (deployed under its own name).
      batching: front each model with a :class:`MicroBatcher` (recommended
        for many small concurrent requests; large analytical requests may
        prefer ``batching=False`` and direct bucket-sized calls).
      deadline_ms / queue_depth: batcher knobs (default from the
        artifact's config: ``serve_batch_deadline_ms`` /
        ``serve_queue_depth``).
      heartbeat: ``(event, **fields)`` observability callable shared with
        the batchers (``utils/supervise.Heartbeat`` shape).
    """

    def __init__(self, artifact: Optional[PredictorArtifact] = None, *,
                 batching: bool = False, deadline_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None, heartbeat=None):
        self._models: Dict[str, _Entry] = {}
        self._lock = threading.RLock()
        self._batching = batching
        self._deadline_ms = deadline_ms
        self._queue_depth = queue_depth
        self._hb = heartbeat or (lambda event, **kv: None)
        self._closed = False
        if artifact is not None:
            self.deploy(artifact.name, artifact)

    # ------------------------------------------------------------------
    # registry
    def deploy(self, name: str, artifact: PredictorArtifact) -> None:
        """Install (or replace, bypassing the gate) a model under ``name``.
        First-time deploys are the normal path; prefer stage+swap for
        replacing a live model."""
        check(not self._closed, "Predictor is closed")
        with self._lock:
            ent = self._models.get(name)
            if ent is None:
                ent = _Entry(artifact)
                self._models[name] = ent
                cfg = artifact._gbdt.config
                # health plane: exposition server (obs_health_port knob /
                # LGBM_OBS_HEALTH_PORT env) + per-model SLO objectives
                obs_health.maybe_start(getattr(cfg, "obs_health_port", 0))
                p99 = float(getattr(cfg, "serve_slo_p99_ms", 0.0) or 0.0)
                err = float(getattr(cfg, "serve_slo_error_rate", 0.0) or 0.0)
                if p99 or err:
                    ent.slo = obs_health.register_slo(obs_health.SLOMonitor(
                        name, p99_ms=p99 or None, error_rate=err or None))
                if self._batching:
                    dl = (self._deadline_ms
                          if self._deadline_ms is not None
                          else getattr(cfg, "serve_batch_deadline_ms", 2.0))
                    qd = (self._queue_depth
                          if self._queue_depth is not None
                          else getattr(cfg, "serve_queue_depth", 64))
                    # the batcher resolves the artifact AT BATCH TIME, so a
                    # swap redirects even requests already queued
                    ent.batcher = MicroBatcher(
                        lambda X, e=ent: e.artifact.predict(X),
                        max_batch_rows=artifact.buckets[-1],
                        deadline_ms=dl, queue_depth=qd, name=name,
                        num_features=artifact.num_features,
                        heartbeat=self._hb, slo=ent.slo)
            else:
                ent.previous = ent.artifact
                ent.artifact = artifact
                ent.staged = None       # a direct redeploy voids any stale
                ent.generation += 1     # candidate a later swap could flip in
                self._retune_batcher(ent)
            self._hb("deploy", model=name, generation=ent.generation)

    @staticmethod
    def _retune_batcher(ent: _Entry) -> None:
        """Keep the batcher's coalescing bound AND request width in step
        with the LIVE artifact after a swap/rollback/redeploy (deploy()
        bypasses swap's same-shape gate, so a redeploy may legitimately
        change the feature count)."""
        if ent.batcher is not None:
            ent.batcher.max_batch_rows = ent.artifact.buckets[-1]
            ent.batcher._n_features = ent.artifact.num_features

    def stage(self, name: str, artifact: PredictorArtifact) -> None:
        """Park a new artifact next to the live one; no traffic moves."""
        check(not self._closed, "Predictor is closed")
        with self._lock:
            ent = self._models.get(name)
            if ent is None:
                raise LightGBMError(
                    f"cannot stage for unknown model {name!r}; deploy() a "
                    "first version before staging a replacement")
            ent.staged = artifact
        self._hb("stage", model=name)

    def swap(self, name: str, parity_X=None, atol: float = 1e-5,
             rtol: float = 1e-5) -> int:
        """Parity-gate the staged artifact, then flip atomically.

        Returns the new generation number.  On gate failure the staged
        artifact is dropped (the live one keeps serving) and
        ``LightGBMError`` is raised with the gate's reason."""
        with self._lock:
            ent = self._models.get(name)
            if ent is None or ent.staged is None:
                raise LightGBMError(f"no staged artifact for model {name!r}")
            staged = ent.staged
            live_features = ent.artifact.num_features
            live_classes = ent.artifact.num_class
        if (staged.num_features != live_features
                or staged.num_class != live_classes):
            # an incompatible swap would change the request contract (or
            # the response SHAPE, [N] vs [N, K]) under every client
            with self._lock:
                if ent.staged is staged:
                    ent.staged = None
            raise LightGBMError(
                f"hot-swap rejected for {name!r}: staged artifact is "
                f"{staged.num_features} features x {staged.num_class} "
                f"classes, live is {live_features} x {live_classes}")
        if parity_X is not None:
            # gate OUTSIDE the lock: it runs real predicts
            ok, reason = staged.parity_check(parity_X, atol=atol, rtol=rtol)
            if not ok:
                with self._lock:
                    if ent.staged is staged:    # rollback: live stays live
                        ent.staged = None
                self._hb("swap_rejected", model=name, reason=reason)
                raise LightGBMError(
                    f"hot-swap rejected for {name!r}: {reason}")
        with self._lock:
            if ent.staged is not staged:
                # a newer stage() landed while this swap's gate was running:
                # installing OUR candidate would silently drop the newer one
                raise LightGBMError(
                    f"hot-swap aborted for {name!r}: a newer artifact was "
                    "staged during the parity gate; swap again")
            ent.previous = ent.artifact
            ent.artifact = staged               # the atomic flip
            ent.staged = None
            ent.generation += 1
            gen = ent.generation
            self._retune_batcher(ent)
        self._hb("swap", model=name, generation=gen)
        Log.info("hot-swapped model %s (generation %d)", name, gen)
        return gen

    def rollback(self, name: str) -> int:
        """Flip back to the pre-swap artifact (one step of history)."""
        with self._lock:
            ent = self._models.get(name)
            if ent is None or ent.previous is None:
                raise LightGBMError(
                    f"no previous artifact to roll back to for {name!r}")
            ent.artifact, ent.previous = ent.previous, ent.artifact
            ent.generation += 1
            gen = ent.generation
            self._retune_batcher(ent)
        self._hb("rollback", model=name, generation=gen)
        return gen

    # ------------------------------------------------------------------
    # serving
    def _entry(self, model: Optional[str]) -> _Entry:
        with self._lock:
            if model is None:
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                model = "default"
            ent = self._models.get(model)
            if ent is None:     # snapshot the names while still locked
                deployed = sorted(self._models)
        if ent is None:
            raise LightGBMError(
                f"unknown model {model!r}; deployed: {deployed}")
        return ent

    def predict(self, X, model: Optional[str] = None,
                raw_score: bool = False,
                timeout: Optional[float] = None) -> np.ndarray:
        """Route one request.  With batching on, transformed predictions
        ride the micro-batch queue; ``raw_score`` requests bypass it (the
        batcher carries exactly one output shape per model).  ``timeout``
        bounds only the batched-queue wait — direct calls (batching off,
        or ``raw_score``) replay the bucket graphs synchronously and
        ignore it."""
        check(not self._closed, "Predictor is closed")
        ent = self._entry(model)
        if ent.batcher is not None and not raw_score:
            return ent.batcher.predict(X, timeout=timeout)
        # direct path (batching off / raw_score): same end-to-end latency
        # histogram the batched path records in MicroBatcher.predict
        t0 = time.perf_counter()
        try:
            out = ent.artifact.predict(X, raw_score=raw_score)
        except Exception:
            if ent.slo is not None:
                ent.slo.observe(bad=True)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        obs_metrics.histogram("serve.predict_ms").observe(ms)
        if ent.slo is not None:
            ent.slo.observe(latency_ms=ms)
        return out

    def submit(self, X, model: Optional[str] = None):
        """Async submit through the model's micro-batcher."""
        ent = self._entry(model)
        if ent.batcher is None:
            raise LightGBMError(
                "Predictor was built with batching=False; use predict()")
        return ent.batcher.submit(X)

    # ------------------------------------------------------------------
    def models(self) -> Dict[str, dict]:
        """Registry snapshot for observability/routing tables."""
        with self._lock:
            return {name: {"generation": e.generation,
                           "trees": e.artifact.num_trees,
                           "num_class": e.artifact.num_class,
                           "buckets": e.artifact.buckets,
                           "staged": e.staged is not None,
                           "batching": e.batcher is not None,
                           "slo": (e.slo.report()
                                   if e.slo is not None else None)}
                    for name, e in self._models.items()}

    def close(self) -> None:
        self._closed = True
        with self._lock:
            entries = list(self._models.items())
        for name, e in entries:
            if e.batcher is not None:
                e.batcher.close()
            if e.slo is not None:
                obs_health.unregister_slo(name)
