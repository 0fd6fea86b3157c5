"""Process-local metrics of the PyTorch port: counters, gauges, histograms
— and the port's one timing clock.

The port's copy of ``repro/obs/metrics.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_serve_features.py`` and
``tests/test_torch_scheduler.py`` pin it to the reference.  Series are
keyed by ``(name, sorted(labels))`` in one :class:`MetricsRegistry` per
process (:func:`registry`); an emission is a dict update on the host, so
turning metrics off (:func:`set_metrics_enabled`) can change neither pool
bytes nor launch accounting.  The serving engine writes the reference's
series names: ``serve.ring_occupancy`` / ``serve.ring_limit`` (gauges),
``serve.ring_shrinks`` / ``serve.ring_regrows`` (counters), and the
engine's ``engine.stage_limit`` gauge; the scheduler writes the
``lane.*`` counters and the ``sched.round_us`` histogram.

Raw wall-clock reads of the port live here only: :func:`now`,
:class:`Stopwatch` and :func:`time_us` (host clock; none waits for the
card).  :func:`percentile` and :func:`summarize` are the one statistic
every readout reports.

Stdlib only.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: a series key: (metric name, sorted (label, value) pairs)
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def now() -> float:
    """Monotonic wall-clock seconds (``time.perf_counter``)."""
    return time.perf_counter()


def _key(name: str, labels: Dict[str, object]) -> SeriesKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class MetricsRegistry:
    """One process's metric store: counters, gauges and histograms with
    labeled series.  ``enabled=False`` turns every emission into a no-op
    without touching callers."""

    def __init__(self) -> None:
        self.enabled = True
        self.counters: Dict[SeriesKey, float] = {}
        self.gauges: Dict[SeriesKey, float] = {}
        self.hists: Dict[SeriesKey, List[float]] = {}
        #: histogram sample cap per series (oldest samples drop)
        self.hist_cap = 4096

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

    def observe(self, name: str, value: float, **labels) -> None:
        """Append ``value`` to the histogram series ``name{labels}``
        (bounded at ``hist_cap`` samples; oldest drop)."""
        if not self.enabled:
            return
        h = self.hists.setdefault(_key(name, labels), [])
        h.append(float(value))
        if len(h) > self.hist_cap:
            del h[:len(h) - self.hist_cap]

    # -- reads ---------------------------------------------------------
    def get(self, name: str, **labels) -> float:
        """Counter value of ``name{labels}`` (0.0 when never emitted)."""
        return self.counters.get(_key(name, labels), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        """Gauge value of ``name{labels}``, or None when never set."""
        return self.gauges.get(_key(name, labels))

    def hist(self, name: str, **labels) -> List[float]:
        """Histogram samples of ``name{labels}`` (copy; [] when empty)."""
        return list(self.hists.get(_key(name, labels), ()))

    def series(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every counter series under ``name``: label tuple -> value."""
        return {k[1]: v for k, v in self.counters.items() if k[0] == name}

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict dump of every series (counters, gauges and histogram
        summaries), names formatted ``name{label=value,...}``."""
        def fmt(k: SeriesKey) -> str:
            name, labels = k
            if not labels:
                return name
            inner = ",".join(f"{a}={b}" for a, b in labels)
            return f"{name}{{{inner}}}"
        return {
            "counters": {fmt(k): v for k, v in self.counters.items()},
            "gauges": {fmt(k): v for k, v in self.gauges.items()},
            "histograms": {fmt(k): summarize(v)
                           for k, v in self.hists.items()},
        }

    def reset(self) -> None:
        """Drop every series."""
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()


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


def observe(name: str, value: float, **labels) -> None:
    """Observe a histogram sample on the process registry."""
    _REGISTRY.observe(name, value, **labels)


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
# timing helpers — the shared statistic every readout reports
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


def time_us(fn: Callable[[], object], *, warmup: int = 2,
            reps: int = 5) -> List[float]:
    """Run ``fn`` ``warmup`` times untimed, then ``reps`` timed; returns
    the per-rep wall-clock in microseconds (host clock: ``fn`` must
    synchronize with the card itself if its work is to be counted)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        t0 = now()
        fn()
        out.append((now() - t0) * 1e6)
    return out


def percentile(xs: Iterable[float], q: float) -> float:
    """The ``q``-th percentile of ``xs`` (linear interpolation; 0.0 on an
    empty input)."""
    data = sorted(float(x) for x in xs)
    if not data:
        return 0.0
    if len(data) == 1:
        return data[0]
    pos = (len(data) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(data) - 1)
    frac = pos - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


def summarize(xs: Iterable[float]) -> Dict[str, float]:
    """p50 / p90 / p99, mean, min, max and n of a sample list."""
    data = [float(x) for x in xs]
    if not data:
        return {"n": 0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
                "mean": 0.0, "min": 0.0, "max": 0.0}
    return {
        "n": len(data),
        "p50": percentile(data, 50),
        "p90": percentile(data, 90),
        "p99": percentile(data, 99),
        "mean": sum(data) / len(data),
        "min": min(data),
        "max": max(data),
    }


__all__ = ["MetricsRegistry", "registry", "inc", "set_gauge", "observe",
           "get", "gauge_value", "snapshot", "reset", "metrics_enabled",
           "set_metrics_enabled", "now", "Stopwatch", "time_us",
           "percentile", "summarize"]
