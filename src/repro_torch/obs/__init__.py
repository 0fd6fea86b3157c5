"""Observability of the PyTorch port: the counter and gauge registry
(:mod:`repro_torch.obs.metrics`, from ``repro/obs/metrics.py``).

The reference's histograms, ``obs/trace.py`` (flush spans) and
``obs/autotune.py`` (tuned profiles) are not ported yet.
"""
from repro_torch.obs.metrics import (MetricsRegistry, Stopwatch, gauge_value,
                                     get, inc, metrics_enabled, now,
                                     registry, reset, set_gauge,
                                     set_metrics_enabled, snapshot)

__all__ = ["MetricsRegistry", "registry", "inc", "set_gauge", "get",
           "gauge_value", "snapshot", "reset", "metrics_enabled",
           "set_metrics_enabled", "now", "Stopwatch"]
