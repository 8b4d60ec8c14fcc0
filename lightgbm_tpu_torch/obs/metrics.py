"""Process-wide metrics: counters, gauges, rolling-percentile histograms.

The registry is the in-memory side of the telemetry layer: instrumentation
points (boosting loop, stream pipeline, distributed reductions, serve
batcher) update named metrics cheaply and thread-safely; anyone —
``obs.report``, the serve heartbeat, a test — takes a :func:`snapshot` on
demand.  Nothing here touches torch or does I/O.

Histograms use reservoir sampling (Vitter's algorithm R, fixed-size
uniform sample) so online p50/p99 over an unbounded observation stream
costs O(reservoir) memory and O(1) amortized per observation — the
serve-path latency reporting shape (p50/p99 under load) without keeping
every request's latency.
"""
from __future__ import annotations

import random
import threading
import zlib
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "counter", "gauge", "histogram",
           "snapshot", "reset"]


class Counter:
    """Monotonically increasing integer."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar; ``set_max`` keeps the running maximum."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: float = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def set_max(self, v: float) -> None:
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Rolling-percentile histogram over a fixed-size uniform reservoir.

    Tracks exact count/sum/min/max; percentiles come from the reservoir
    (exact until ``reservoir_size`` observations, uniformly sampled
    after).  The sampler is seeded from the metric name so snapshots are
    reproducible run to run for a fixed observation stream.
    """

    def __init__(self, name: str, reservoir_size: int = 512):
        if reservoir_size < 1:
            raise ValueError("reservoir_size must be >= 1")
        self.name = name
        self.reservoir_size = int(reservoir_size)
        self._lock = threading.Lock()
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._sample: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._sample) < self.reservoir_size:
                self._sample.append(v)
            else:
                # algorithm R: keep each of the n seen values with p = k/n
                j = self._rng.randrange(self._count)
                if j < self.reservoir_size:
                    self._sample[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile from the reservoir; None when empty."""
        with self._lock:
            if not self._sample:
                return None
            xs = sorted(self._sample)
        i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
        return xs[i]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            if not self._count:
                return {"type": "histogram", "count": 0}
            out = {"type": "histogram", "count": self._count,
                   "sum": self._sum, "min": self._min, "max": self._max,
                   "mean": self._sum / self._count}
            xs = sorted(self._sample)
        for label, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
            i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
            out[label] = xs[i]
        return out


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    Accessors are type-checked: asking for ``counter("x")`` after someone
    registered ``x`` as a gauge is a programming error worth failing on.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"not a {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, reservoir_size: int = 512) -> Histogram:
        return self._get(name, Histogram, reservoir_size)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Point-in-time dump of every metric, name-sorted (JSON-ready)."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, reservoir_size: int = 512) -> Histogram:
    return _REGISTRY.histogram(name, reservoir_size)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()
