"""Serving: bucketed CUDA-graph predictors behind a micro-batching front
end with hot-swap (the port of the JAX package's ``serve/``).

Three layers, composable or standalone:

- :mod:`.artifact` — :class:`PredictorArtifact`: a trained ensemble frozen
  into stacked device tensors with the raw->traverse->accumulate pipeline
  captured as one CUDA graph per bucketed batch shape (no per-request
  capture; the output transform on the host, as ``GBDT.predict`` runs it).
- :mod:`.batcher` — :class:`MicroBatcher`: a threaded request queue that
  coalesces concurrent requests up to a deadline, pads to the nearest
  bucket, fans results back out, and sheds load with a clear refusal when
  saturated.
- :mod:`.server` — :class:`Predictor`: the multi-model front end with
  per-model routing and atomic hot-swap (stage -> parity gate -> flip,
  rollback on failure) so a new ensemble ships with zero downtime.
"""
from .artifact import DEFAULT_BUCKETS, PredictorArtifact
from .batcher import MicroBatcher, QueueSaturatedError
from .server import Predictor

__all__ = ["PredictorArtifact", "MicroBatcher", "Predictor",
           "QueueSaturatedError", "DEFAULT_BUCKETS"]
