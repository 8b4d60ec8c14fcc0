"""Frozen ensemble predictor artifacts: bucketed, captured as CUDA graphs.

Port of the JAX package's ``serve/artifact.py``.  The training-side device
predictor (``ops/ensemble.py``) runs a Python loop over trees and depth
levels, so one request launches several thousand small kernels.  A
:class:`PredictorArtifact` freezes a trained ensemble into the serving
shape:

- every tree flattened and padded into stacked device tensors
  (``stack_trees``), with each tree's depth and categorical flag on the
  host, so the traversal never reads the device;
- the raw -> traverse -> Kahan-accumulate pipeline captured ONCE per
  bucketed row count as a ``torch.cuda.CUDAGraph`` over a static ``[b, F]``
  float32 input buffer, at construction (the counterpart of the JAX
  package's ahead-of-time XLA programs), so a request replays one graph;
- requests padded up to the nearest bucket (pad rows are traversed but
  every row is independent, so real rows are untouched) and chunked by the
  largest bucket, so ANY request size is served by a fixed, finite graph
  set: ``compile_count`` is ``len(buckets)``, forever.

The graph replays exactly the eager kernels that ``GBDT.predict`` launches
on its device path (``pred_device=device``), so raw scores are bit-exact
against it.  The output transform (``ObjectiveFunction.convert_output``)
runs on the raw scores the graph returns, on the host in float32 as
``GBDT.predict`` runs it, so transformed scores are bit-exact too.  A
capture that fails raises; the artifact never serves eagerly on the card.

On the CPU (``device="cpu"``) nothing is captured: the same function runs
eagerly on a padded CPU tensor, and ``compile_count`` counts the buckets
prepared.  The JAX package shards rows over a 1-D device mesh; here the
single device stands in for that mesh, and row sharding over several
cards waits for the distributed slice (``parallel/``).

Artifacts save and load through the ``model_io`` text grammar plus one
trailing ``serving_config:`` line that the model parser ignores, so the
file stays loadable by ``Booster(model_file=...)`` of both packages.
"""
from __future__ import annotations

import functools
import json
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SERVE_DEFAULT_BUCKETS as DEFAULT_BUCKETS
from ..device import resolve_device
from ..models import model_io
from ..models.gbdt import GBDT
from ..obs import costs as obs_costs
from ..ops.ensemble import predict_raw_ensemble, stack_trees
from ..utils.log import LightGBMError, Log, check

# ONE execution lock for ALL artifacts, not per instance: the static input
# and output buffers of a bucket are shared by every caller, and a
# hot-swap has in-flight requests on the old artifact while new ones (and
# the parity gate) hit the new one.  One card serializes the graphs
# anyway, so the global lock costs no throughput.
_EXEC_LOCK = threading.Lock()

# trailing metadata line appended after the model text; the model text
# parser ignores trailing content (the same trick as pandas_categorical)
_SERVE_TAG = "serving_config:"


def _strip_serve_tag(text: str) -> Tuple[str, dict]:
    """Split a saved artifact into (model_text, serving meta)."""
    pos = text.rfind("\n" + _SERVE_TAG)
    if pos < 0:
        return text, {}
    lines = text[pos + 1 + len(_SERVE_TAG):].splitlines()
    meta = {}
    if lines:
        try:
            meta = json.loads(lines[0])
        except ValueError:
            meta = {}
    return text[:pos + 1], meta if isinstance(meta, dict) else {}


def _ens_nbytes(ens) -> int:
    return sum(t.numel() * t.element_size() for t in ens
               if isinstance(t, torch.Tensor))


class PredictorArtifact:
    """One servable model: frozen trees + one captured graph per bucket.

    Build with :meth:`freeze` (from a ``Booster``/``GBDT``),
    :meth:`from_string` (model text) or :meth:`load` (a saved artifact
    file); then :meth:`predict` serves any row count without capturing.
    ``device=None`` means the CUDA card (``NoCudaDeviceError`` without
    one); ``device="cpu"`` runs the pipeline eagerly.
    """

    def __init__(self, gbdt: GBDT, *, model_str: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 name: str = "default", device=None):
        check(gbdt.models, "cannot freeze an ensemble with no trees")
        self.name = name
        self.device = resolve_device(device)
        self._gbdt = gbdt
        self.model_str = model_str or model_io.save_model_to_string(gbdt)
        if buckets is None:
            buckets = getattr(gbdt.config, "serve_buckets", None) \
                or DEFAULT_BUCKETS
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        check(self.buckets and self.buckets[0] > 0,
              "serve buckets must be positive row counts")
        self.num_class = gbdt.num_tree_per_iteration
        self.num_features = gbdt.max_feature_idx + 1
        self.num_trees = len(gbdt.models)
        self._objective = gbdt.objective
        # RF averages its trees (GBDT.predict_raw's average_output)
        self._average = (max(1, self.num_trees // self.num_class)
                         if gbdt.average_output else 0)
        self._ens = stack_trees(gbdt.models, self.device)
        self._x: Dict[int, torch.Tensor] = {}       # [b, F] static inputs
        self._raw: Dict[int, torch.Tensor] = {}     # [K, b] static outputs
        self._graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        # capture seconds and graph-pool bytes per bucket (0 on the CPU)
        self.capture_stats: Dict[int, Dict[str, float]] = {}
        self.compile_count = 0
        self._capture_all()

    # ------------------------------------------------------------------
    # construction fronts
    @classmethod
    def freeze(cls, model, num_iteration: int = -1, start_iteration: int = 0,
               buckets: Optional[Sequence[int]] = None,
               name: str = "default", device=None) -> "PredictorArtifact":
        """Freeze a trained ``Booster`` (or raw ``GBDT``) into an artifact.

        Serializes through the model-text grammar and rebuilds from it, so
        the in-memory artifact is ALWAYS identical to one reloaded after a
        restart (thresholds and leaf values round-trip at %.17g)."""
        gbdt = getattr(model, "_gbdt", model)
        text = model_io.save_model_to_string(
            gbdt, -1 if num_iteration is None else num_iteration,
            start_iteration)
        if buckets is None:
            buckets = getattr(gbdt.config, "serve_buckets", None)
        return cls.from_string(text, buckets=buckets, name=name,
                               device=device)

    @classmethod
    def from_string(cls, text: str, *,
                    buckets: Optional[Sequence[int]] = None,
                    name: Optional[str] = None,
                    device=None) -> "PredictorArtifact":
        model_text, meta = _strip_serve_tag(text)
        dev = resolve_device(device)
        gbdt = model_io.load_model_from_string(
            model_text, functools.partial(GBDT, device=dev))
        if buckets is None:
            buckets = meta.get("buckets") \
                or getattr(gbdt.config, "serve_buckets", None)
        return cls(gbdt, model_str=model_text, buckets=buckets,
                   name=name or meta.get("name") or "default", device=dev)

    @classmethod
    def load(cls, path: str, *, buckets: Optional[Sequence[int]] = None,
             name: Optional[str] = None, device=None) -> "PredictorArtifact":
        with open(path) as f:
            return cls.from_string(f.read(), buckets=buckets, name=name,
                                   device=device)

    def save(self, path: str) -> "PredictorArtifact":
        """Model text + one trailing ``serving_config:`` metadata line.
        The file stays loadable by ``Booster(model_file=...)``."""
        meta = {"name": self.name, "buckets": list(self.buckets),
                "num_class": self.num_class,
                "num_features": self.num_features}
        with open(path, "w") as f:
            f.write(self.model_str)
            if not self.model_str.endswith("\n"):
                f.write("\n")
            f.write(_SERVE_TAG + json.dumps(meta) + "\n")
        return self

    # ------------------------------------------------------------------
    # graph capture
    def _pipeline(self, x: torch.Tensor) -> torch.Tensor:
        """raw -> traverse -> Kahan accumulate: ``[K, rows]`` float32, the
        ops ``GBDT._predict_raw_device`` runs."""
        return predict_raw_ensemble(self._ens, x, self.num_class)

    def _capture_all(self) -> None:
        F, K = self.num_features, self.num_class
        cuda = self.device.type == "cuda"
        chip = obs_costs.current_chip(self.device)
        for b in self.buckets:
            t0 = time.perf_counter()
            x = torch.zeros(b, F, dtype=torch.float32, device=self.device)
            pool_bytes = 0
            if cuda:
                # warm up on a side stream (the allocator and the lazy
                # kernel loads must not happen inside the capture), then
                # capture into the bucket's own memory pool; an error
                # inside the capture raises out of here.  The capture
                # holds the execution lock: no other artifact's request
                # may launch work while a stream captures
                with _EXEC_LOCK:
                    # the pool's bytes: what the allocator keeps reserved
                    # once its free cached blocks are released
                    torch.cuda.empty_cache()
                    reserved = torch.cuda.memory_reserved(self.device)
                    side = torch.cuda.Stream(self.device)
                    side.wait_stream(torch.cuda.current_stream(self.device))
                    with torch.cuda.stream(side):
                        self._pipeline(x)
                    torch.cuda.current_stream(self.device).wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        self._raw[b] = self._pipeline(x)
                    torch.cuda.synchronize(self.device)
                    torch.cuda.empty_cache()
                    pool_bytes = (torch.cuda.memory_reserved(self.device)
                                  - reserved)
                self._graphs[b] = graph
            self._x[b] = x
            self.compile_count += 1
            self.capture_stats[b] = {"seconds": time.perf_counter() - t0,
                                     "pool_bytes": pool_bytes}
            # the artifact's cost record per bucket, from its shapes: the
            # request rows read, the raw scores written, the stacked
            # trees read; predict() joins the wall times
            obs_costs.get_ledger().record(
                f"serve.{self.name}.b{b}",
                cost={"bytes_accessed": 4 * b * (F + K)
                      + _ens_nbytes(self._ens)},
                memory={"peak_bytes": pool_bytes} if cuda else None,
                chip=chip, rows=b, features=F, num_class=K)
        Log.debug("PredictorArtifact %s: prepared %d bucket graphs %s",
                  self.name, self.compile_count, self.buckets)

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _run(self, b: int, xp: np.ndarray) -> np.ndarray:
        """The raw scores ``[rows, K]`` float64 of one bucket-sized chunk
        (the caller holds ``_EXEC_LOCK``)."""
        x = self._x[b]
        x.copy_(torch.from_numpy(xp))
        if self.device.type == "cuda":
            self._graphs[b].replay()
            raw = self._raw[b]
        else:
            raw = self._pipeline(x)
        return raw.cpu().numpy().astype(np.float64).T

    # ------------------------------------------------------------------
    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        """Serve one request: ``[N, F]`` raw features -> ``[N]`` (or
        ``[N, K]`` multiclass) predictions.  Never captures: the request is
        padded to the nearest bucket and chunked by the largest one."""
        X = np.asarray(getattr(X, "values", X))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] != self.num_features:
            raise LightGBMError(
                f"artifact {self.name!r} expects {self.num_features} "
                f"features, request has {X.shape[1]}")
        n = X.shape[0]
        K = self.num_class
        raw = np.empty((n, K), np.float64)
        X32 = np.ascontiguousarray(X, np.float32)
        cap = self.buckets[-1]
        for s in range(0, n, cap):
            chunk = X32[s:s + cap]
            b = self._bucket_for(chunk.shape[0])
            if chunk.shape[0] == b:     # exact fill: skip the pad copy
                xp = chunk
            else:
                xp = np.zeros((b, self.num_features), np.float32)
                xp[:chunk.shape[0]] = chunk
            with _EXEC_LOCK:
                t0 = time.perf_counter()
                picked = self._run(b, xp)
                obs_costs.get_ledger().observe(
                    f"serve.{self.name}.b{b}", time.perf_counter() - t0)
            raw[s:s + chunk.shape[0]] = picked[:chunk.shape[0]]
        if self._average:
            raw = raw / self._average
        out = raw[:, 0] if K == 1 else raw
        if raw_score or self._objective is None:
            return out
        # GBDT.predict's transform, on the same float64 raw scores
        if K > 1:
            return np.asarray(self._objective.convert_output(out.T)).T
        return np.asarray(self._objective.convert_output(out))

    # ------------------------------------------------------------------
    def parity_check(self, X, atol: float = 1e-5,
                     rtol: float = 1e-5) -> Tuple[bool, str]:
        """Hot-swap gate: the captured pipeline against an independent
        host-side per-tree reference on the same sample.  Catches a frozen
        artifact whose graphs are wrong (corrupted tensors, wrong
        transform) BEFORE it takes traffic.  Returns (ok, reason)."""
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        got = np.asarray(self.predict(X), np.float64)
        if not np.all(np.isfinite(got)):
            return False, "non-finite outputs from the captured pipeline"
        ref = self._host_reference(X)
        if got.shape != ref.shape:
            return False, f"shape mismatch: {got.shape} vs {ref.shape}"
        if not np.allclose(got, ref, atol=atol, rtol=rtol):
            worst = float(np.max(np.abs(got - ref)))
            return False, f"captured/host mismatch (max abs err {worst:g})"
        return True, "ok"

    def _host_reference(self, X: np.ndarray) -> np.ndarray:
        K = self.num_class
        raw = np.zeros((X.shape[0], K))
        for ti, t in enumerate(self._gbdt.models):
            raw[:, ti % K] += t.predict(X)
        if self._average:
            raw = raw / self._average
        obj = self._objective
        if obj is None:
            out = raw
        elif K > 1:
            out = np.asarray(obj.convert_output(raw.T)).T
        else:
            out = np.asarray(obj.convert_output(raw[:, 0]))[:, None]
        return np.asarray(out[:, 0] if K == 1 else out, np.float64)

    def __repr__(self) -> str:
        return (f"PredictorArtifact(name={self.name!r}, "
                f"trees={self.num_trees}, num_class={self.num_class}, "
                f"features={self.num_features}, buckets={self.buckets}, "
                f"device={self.device}, compiles={self.compile_count})")
