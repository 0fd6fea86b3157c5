"""Process-local metrics of the PyTorch port: counters and gauges.

The counter and gauge part of ``repro/obs/metrics.py`` (the port imports
nothing of the JAX package; its histograms and bench timing helpers are not
copied); ``tests/test_torch_serve_features.py`` pins it to the reference.
Series are keyed by ``(name, sorted(labels))`` in one
:class:`MetricsRegistry` per process (:func:`registry`); an emission is a
dict update on the host, so turning metrics off
(:func:`set_metrics_enabled`) can change neither pool bytes nor launch
accounting.  The serving engine writes the reference's series names:
``serve.ring_occupancy`` / ``serve.ring_limit`` (gauges),
``serve.ring_shrinks`` / ``serve.ring_regrows`` (counters), and the
engine's ``engine.stage_limit`` gauge.

Stdlib only.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

#: a series key: (metric name, sorted (label, value) pairs)
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def now() -> float:
    """Monotonic wall-clock seconds (``time.perf_counter``)."""
    return time.perf_counter()


def _key(name: str, labels: Dict[str, object]) -> SeriesKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class MetricsRegistry:
    """One process's metric store: counters and gauges with labeled
    series.  ``enabled=False`` turns every emission into a no-op
    without touching callers."""

    def __init__(self) -> None:
        self.enabled = True
        self.counters: Dict[SeriesKey, float] = {}
        self.gauges: Dict[SeriesKey, float] = {}

    # -- emission ------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add ``value`` to the counter series ``name{labels}``."""
        if not self.enabled:
            return
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Set the gauge series ``name{labels}`` to ``value``."""
        if not self.enabled:
            return
        self.gauges[_key(name, labels)] = float(value)

    # -- reads ---------------------------------------------------------
    def get(self, name: str, **labels) -> float:
        """Counter value of ``name{labels}`` (0.0 when never emitted)."""
        return self.counters.get(_key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        """Gauge value of ``name{labels}``, or None when never set."""
        return self.gauges.get(_key(name, labels))

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict dump of every series (counters and gauges), names
        formatted ``name{label=value,...}``."""
        def fmt(k: SeriesKey) -> str:
            name, labels = k
            if not labels:
                return name
            inner = ",".join(f"{a}={b}" for a, b in labels)
            return f"{name}{{{inner}}}"
        return {
            "counters": {fmt(k): v for k, v in self.counters.items()},
            "gauges": {fmt(k): v for k, v in self.gauges.items()},
        }

    def reset(self) -> None:
        """Drop every series."""
        self.counters.clear()
        self.gauges.clear()


#: the process registry every instrumented module emits into
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-local :class:`MetricsRegistry`."""
    return _REGISTRY


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Increment a counter on the process registry."""
    _REGISTRY.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a gauge on the process registry."""
    _REGISTRY.set_gauge(name, value, **labels)


def get(name: str, **labels) -> float:
    """Counter value on the process registry (0.0 when never emitted)."""
    return _REGISTRY.get(name, **labels)


def gauge_value(name: str, **labels) -> Optional[float]:
    """Gauge value on the process registry, or None when never set."""
    return _REGISTRY.gauge_value(name, **labels)


def snapshot() -> Dict[str, Dict]:
    """:meth:`MetricsRegistry.snapshot` of the process registry."""
    return _REGISTRY.snapshot()


def reset() -> None:
    """Drop every series of the process registry."""
    _REGISTRY.reset()


def metrics_enabled() -> bool:
    """Is the process registry recording emissions?"""
    return _REGISTRY.enabled


def set_metrics_enabled(flag: bool) -> bool:
    """Enable or disable the process registry; returns the PREVIOUS
    state."""
    prev = _REGISTRY.enabled
    _REGISTRY.enabled = bool(flag)
    return prev


# ---------------------------------------------------------------------------
# timing helper
# ---------------------------------------------------------------------------

class Stopwatch:
    """Context-manager wall-clock timer over :func:`now` (host clock; it
    does not wait for the card)."""

    def __init__(self) -> None:
        self.start = 0.0
        self.end: Optional[float] = None

    def __enter__(self) -> "Stopwatch":
        self.start = now()
        return self

    def __exit__(self, *exc) -> None:
        self.end = now()

    @property
    def s(self) -> float:
        """Elapsed seconds (running total until the context exits)."""
        return (self.end if self.end is not None else now()) - self.start

    @property
    def us(self) -> float:
        """Elapsed microseconds."""
        return self.s * 1e6


__all__ = ["MetricsRegistry", "registry", "inc", "set_gauge", "get",
           "gauge_value", "snapshot", "reset", "metrics_enabled",
           "set_metrics_enabled", "now", "Stopwatch"]
