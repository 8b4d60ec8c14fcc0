"""Cost ledger + roofline/MFU accounting (device-truth attribution).

The port's copy of the JAX package's ``obs/costs.py``: one audited peak
table and one cost model for the port.  Every peak-rate figure the port
prints (``chip_smoke.py``'s bounds, ``obs-report --roofline``) comes
through here — ``tests/test_torch_obs.py`` greps the port to enforce it.

There is no compiled program to analyse on the card, so the ledger takes
the port's own count of a program's work (:meth:`CostLedger.record`'s
``cost`` and ``memory``): the GBDT counts the bytes its histogram calls
read and write (``ops/histogram.py::hist_bytes``) and reads the device
allocator's peak over its first tree.

Stdlib-only at import: torch is imported inside the few functions that
touch a device.

Two layers:

- **peaks + math** — :data:`PEAK_RATES` (dense bf16 FLOP/s + HBM B/s per
  chip kind, and the H100's f32 and int8 rates beside them),
  :func:`peak_flops`, :func:`peak_bandwidth`, :func:`mfu`,
  :func:`arithmetic_intensity`, :func:`ridge_intensity`,
  :func:`roofline` (the full achieved-vs-peak record with the
  compute-vs-bandwidth-bound classification);
- **ledger** — :class:`CostLedger` records named programs' counted cost
  (bytes accessed, flops where there is tensor-core work) and device
  memory, joins them with measured wall times, and emits one
  ``program_cost`` schema event per program through the existing
  :class:`~.events.EventLog` for ``obs-report --roofline`` to render.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from ..utils.log import LightGBMError

__all__ = ["PEAK_RATES", "normalize_chip", "peak_flops",
           "peak_bandwidth", "mfu", "arithmetic_intensity",
           "ridge_intensity", "classify_bound", "roofline", "CostLedger",
           "get_ledger", "reset_ledger", "current_chip",
           "record_watermarks", "set_stats_provider", "COST_EVENT"]

#: event name the ledger emits per program (rendered by --roofline)
COST_EVENT = "program_cost"

#: the table's rates are written as the data sheets give them, in TFLOP/s
#: and TB/s, and scaled by this
_TERA = 1e12

# --------------------------------------------------------------------------
# THE peak table.  Per-chip dense-bf16 matmul peak (``flops``) and memory
# bandwidth (``bytes_per_sec``); the H100 row also carries its f32 rate
# outside the tensor cores and its dense int8 tensor-core rate, which the
# kernels' bounds read.  The CPU row is a deliberately round
# container-class estimate so CPU runs still produce a finite, labelled
# MFU instead of a lie or a crash.
# --------------------------------------------------------------------------
PEAK_RATES: Dict[str, Dict[str, float]] = {
    # NVIDIA H100 SXM5 (80GB HBM3) data sheet, at its 700 W limit
    "h100": {"flops": 989.0 * _TERA, "bytes_per_sec": 3.35 * _TERA,
             "f32_flops": 67.0 * _TERA, "int8_ops": 1979.0 * _TERA},
    "cpu": {"flops": 3.3 * _TERA, "bytes_per_sec": 0.15 * _TERA},
}


def normalize_chip(kind: Optional[str]) -> str:
    """Map a card name (``torch.cuda.get_device_name``) or a platform
    string onto a peak-table key.  An H100 SXM ("NVIDIA H100 80GB HBM3")
    is ``"h100"``; any other card raises ``LightGBMError`` naming it:
    pricing it against the H100's peaks would print a wrong share."""
    k = (kind or "").strip().lower()
    if k in PEAK_RATES:
        return k
    if "cpu" in k or k == "":
        return "cpu"
    if ("h100" in k and ("hbm3" in k or "sxm" in k)
            and "nvl" not in k and "pcie" not in k):
        return "h100"
    raise LightGBMError(f"no peak rates for the card {kind!r}: the peak "
                        "table (lightgbm_tpu_torch/obs/costs.py) knows "
                        f"{', '.join(sorted(PEAK_RATES))}")


def peak_flops(kind: Optional[str]) -> float:
    return PEAK_RATES[normalize_chip(kind)]["flops"]


def peak_bandwidth(kind: Optional[str]) -> float:
    return PEAK_RATES[normalize_chip(kind)]["bytes_per_sec"]


def mfu(flops: float, seconds: float, kind: Optional[str]) -> float:
    """Model FLOPs Utilization: achieved FLOP/s over the chip's peak."""
    if seconds <= 0.0:
        return 0.0
    return flops / seconds / peak_flops(kind)


def arithmetic_intensity(flops: float, bytes_accessed: float) -> float:
    """FLOPs per byte moved (the roofline x-axis)."""
    return flops / bytes_accessed if bytes_accessed > 0 else float("inf")


def ridge_intensity(kind: Optional[str]) -> float:
    """The roofline ridge point: intensities above it are compute-bound."""
    return peak_flops(kind) / peak_bandwidth(kind)


def classify_bound(intensity: float, kind: Optional[str]) -> str:
    return ("compute" if intensity >= ridge_intensity(kind)
            else "bandwidth")


def roofline(flops: float, bytes_accessed: float, seconds: float,
             kind: Optional[str]) -> Dict[str, Any]:
    """Full achieved-vs-peak record for one timed program execution."""
    chip = normalize_chip(kind)
    ach_f = flops / seconds if seconds > 0 else 0.0
    ach_b = bytes_accessed / seconds if seconds > 0 else 0.0
    ai = arithmetic_intensity(flops, bytes_accessed)
    return {
        "chip": chip,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "seconds": seconds,
        "achieved_flops_per_sec": ach_f,
        "achieved_bytes_per_sec": ach_b,
        "mfu": ach_f / peak_flops(chip),
        "hbm_util": ach_b / peak_bandwidth(chip),
        "intensity": ai,
        "ridge_intensity": ridge_intensity(chip),
        "bound": classify_bound(ai, chip),
    }


# --------------------------------------------------------------------------
# device access (torch imported lazily)
# --------------------------------------------------------------------------

def current_chip(device: Any) -> str:
    """Peak-table key of a model's ``device`` (a ``torch.device`` or its
    string): the card's name on a CUDA device, ``"cpu"`` on the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return normalize_chip(torch.cuda.get_device_name(dev))
    return normalize_chip(dev.type)


#: test seam for :func:`record_watermarks` — the CPU has no allocator
#: statistics, so CPU-only tests inject a fake provider here
_STATS_PROVIDER: Optional[Callable[[], Optional[Dict[str, Any]]]] = None


def set_stats_provider(
        fn: Optional[Callable[[], Optional[Dict[str, Any]]]]) -> None:
    global _STATS_PROVIDER
    _STATS_PROVIDER = fn


def _device_memory_stats(device: Any) -> Optional[Dict[str, Any]]:
    """The CUDA caching allocator's bytes in use and their peak on
    ``device`` (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``
    and ``.peak``); None on the CPU.  A failed read on a CUDA device
    raises."""
    if _STATS_PROVIDER is not None:
        return _STATS_PROVIDER()
    if device is None:
        return None
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"])}


def record_watermarks(prefix: str, registry: Any = None,
                      device: Any = None) -> Dict[str, int]:
    """Mirror the device's memory watermarks into the metrics registry as
    ``<prefix>.device_bytes_in_use`` (last value) and
    ``<prefix>.device_peak_bytes_in_use`` (monotone max).  A host-side
    read of the allocator's counters, no device sync; returns ``{}`` on
    the CPU, which has no such counters, so call sites never need to
    branch."""
    stats = _device_memory_stats(device)
    if not stats:
        return {}
    if registry is None:
        from .metrics import get_registry
        registry = get_registry()
    out: Dict[str, int] = {}
    if "bytes_in_use" in stats:
        v = int(stats["bytes_in_use"])
        registry.gauge(f"{prefix}.device_bytes_in_use").set(v)
        out["bytes_in_use"] = v
    if "peak_bytes_in_use" in stats:
        v = int(stats["peak_bytes_in_use"])
        registry.gauge(f"{prefix}.device_peak_bytes_in_use").set_max(v)
        out["peak_bytes_in_use"] = v
    return out


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

class CostLedger:
    """Named-program registry of counted cost and device memory joined
    with measured wall time.

    ``record(name, cost=..., memory=..., **meta)`` takes the caller's
    count once; ``observe(name, seconds)`` accumulates measured
    executions; ``rooflines()`` joins the two against the peak table;
    ``emit(log)`` appends one ``program_cost`` schema event per program
    for ``obs-report --roofline``.
    """

    def __init__(self, chip: Optional[str] = None):
        self._chip = chip
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict[str, Any]] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._programs

    def names(self) -> List[str]:
        return list(self._programs)

    def entry(self, name: str) -> Dict[str, Any]:
        return dict(self._programs[name])

    # ------------------------------------------------------------------
    def record(self, name: str, *,
               cost: Optional[Dict[str, float]] = None,
               memory: Optional[Dict[str, int]] = None,
               chip: Optional[str] = None, model_flops: Optional[float] = None,
               predicted_mfu: Optional[float] = None, **meta: Any) -> Dict:
        """Register/refresh a program.  ``cost`` is the caller's count of
        one execution's work: ``bytes_accessed``, and ``flops`` only where
        the program does that work; ``memory`` its
        device memory (``peak_bytes``); ``chip`` a peak-table key or a card
        name (default: the ledger's).  Pass ``model_flops`` for an
        analytic work model, ``predicted_mfu`` for a work-model MFU
        bound."""
        chip = chip or self._chip
        if chip is None:
            raise LightGBMError(f"CostLedger.record({name!r}) needs the "
                                "chip: pass chip=current_chip(device)")
        ent: Dict[str, Any] = {"program": name, "chip": normalize_chip(chip)}
        if cost is not None:
            ent["cost"] = {k: float(v) for k, v in cost.items()}
        if memory is not None:
            ent["memory"] = {k: int(v) for k, v in memory.items()}
        if model_flops is not None:
            ent["model_flops"] = float(model_flops)
        if predicted_mfu is not None:
            ent["predicted_mfu"] = float(predicted_mfu)
        if meta:
            ent["meta"] = {k: v for k, v in meta.items()}
        with self._lock:
            prev = self._programs.get(name, {})
            ent.setdefault("calls", prev.get("calls", 0))
            ent.setdefault("total_seconds", prev.get("total_seconds", 0.0))
            self._programs[name] = ent
        return ent

    def observe(self, name: str, seconds: float, calls: int = 1) -> None:
        """Join ``calls`` measured executions totalling ``seconds`` with
        the program's recorded analysis (no-op for unknown names so call
        sites need no existence branch)."""
        if seconds is None or seconds < 0:
            return
        with self._lock:
            ent = self._programs.get(name)
            if ent is None:
                return
            ent["calls"] = ent.get("calls", 0) + int(calls)
            ent["total_seconds"] = ent.get("total_seconds", 0.0) + float(seconds)

    # ------------------------------------------------------------------
    def rooflines(self) -> List[Dict[str, Any]]:
        """One achieved-vs-peak record per OBSERVED program (programs with
        analysis but no timings are skipped: no wall time, no rate)."""
        out = []
        with self._lock:
            entries = [dict(e) for e in self._programs.values()]
        for ent in entries:
            calls = ent.get("calls", 0)
            secs = ent.get("total_seconds", 0.0)
            if not calls or secs <= 0:
                continue
            cost = ent.get("cost", {})
            flops = cost.get("flops", ent.get("model_flops", 0.0)) * calls
            byts = cost.get("bytes_accessed", 0.0) * calls
            rec = roofline(flops, byts, secs, ent["chip"])
            rec.update(program=ent["program"], calls=calls,
                       seconds_per_call=secs / calls,
                       flops_source=("counted" if "flops" in cost
                                     else "model"))
            for k in ("model_flops", "predicted_mfu", "memory", "meta"):
                if k in ent:
                    rec[k] = ent[k]
            if "model_flops" in ent:
                rec["model_mfu"] = mfu(ent["model_flops"] * calls, secs,
                                       ent["chip"])
            out.append(rec)
        return out

    def emit(self, log: Any = None, event: str = COST_EVENT) -> int:
        """Append one schema event per observed program; returns the
        count.  ``log`` defaults to the shared journal writer."""
        if log is None:
            from .events import EventLog
            log = EventLog.default()
        rows = self.rooflines()
        for rec in rows:
            log.emit(event, **_round_floats(rec))
        return len(rows)


def _round_floats(obj: Any, nd: int = 6) -> Any:
    if isinstance(obj, float):
        return round(obj, nd) if obj == obj and abs(obj) != float("inf") \
            else str(obj)
    if isinstance(obj, dict):
        return {k: _round_floats(v, nd) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, nd) for v in obj]
    return obj


_LEDGER = CostLedger()


def get_ledger() -> CostLedger:
    """The process-wide ledger (mirrors the metrics-registry pattern)."""
    return _LEDGER


def reset_ledger() -> CostLedger:
    global _LEDGER
    _LEDGER = CostLedger()
    return _LEDGER

