"""Observability and tuning of the PyTorch port (from ``repro/obs``).

Three pieces:

* :mod:`repro_torch.obs.metrics`: process-local counters, gauges and
  histograms with labeled series (stream, opcode, mechanism, tenant lane),
  the port's one timing clock, and the shared timer, ``percentile`` and
  ``summarize`` helpers;
* :mod:`repro_torch.obs.trace`: named spans over the flush lifecycle
  (``flush -> drain``, ``ticket-wait``), ``torch.profiler`` ranges and
  wall-clock :class:`~repro_torch.obs.trace.Span` records;
  :class:`~repro_torch.obs.trace.FlushTiming` rides on
  ``FlushTicket.timing``;
* :mod:`repro_torch.obs.autotune`: per-backend
  :class:`~repro_torch.obs.autotune.TunedProfile` files under
  ``configs/tuned/`` (the reference's schema), written by
  ``launch/autotune.py`` and loaded by the engines at startup; explicit
  kwargs always win.

Nothing here imports ``repro_torch.core`` at module scope (only lazily in
``apply_profile``), so the core can emit into it without an import cycle.
"""
from repro_torch.obs.autotune import (TunedProfile, apply_profile,
                                      backend_key, load_profile, pick_winner,
                                      profile_path, save_profile, tuned_dir)
from repro_torch.obs.metrics import (MetricsRegistry, Stopwatch, gauge_value,
                                     get, inc, metrics_enabled, now, observe,
                                     percentile, registry, reset, set_gauge,
                                     set_metrics_enabled, snapshot,
                                     summarize, time_us)
from repro_torch.obs.trace import (FlushTiming, Span, reset_spans,
                                   set_tracing, span, span_tree, spans,
                                   tracing_enabled)

__all__ = ["MetricsRegistry", "registry", "inc", "set_gauge", "observe",
           "get", "gauge_value", "snapshot", "reset", "metrics_enabled",
           "set_metrics_enabled", "now", "Stopwatch", "time_us",
           "percentile", "summarize", "Span", "FlushTiming", "span", "spans",
           "reset_spans", "tracing_enabled", "set_tracing",
           "span_tree", "TunedProfile", "tuned_dir", "backend_key",
           "profile_path", "save_profile", "load_profile", "apply_profile",
           "pick_winner"]
